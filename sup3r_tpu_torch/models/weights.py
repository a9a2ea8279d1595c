"""Weights in the JAX package's checkpoint format, both ways.

``params_from_jax`` loads the JAX package's per-layer param list
(``[{}, {'bias': ..., 'kernel': DHWIO}, ...]`` of numpy arrays) into the
port's layer modules; ``params_to_jax`` gives that list back;
``chain_params_from_jax`` does it per member of a ``MultiStepGan``.
``load_jax_checkpoint`` / ``save_jax_checkpoint`` read and write a
``model_gen.msgpack`` / ``model_disc.msgpack`` as the JAX package's
``Sup3rGan.save`` does, so save directories are interchangeable;
``restore_state_dict`` fills a template params tree from such a file,
as flax does (``AbstractSingleModel.load_network_params``).
``opt_state_to_jax`` / ``opt_state_from_jax`` carry one network's
optimizer state (optax's chain state: Adam's ``count``, ``mu`` and
``nu``, the momentum ``trace``, RMSprop's ``nu``) to and from flax's
state-dict layout, which ``opt_state.msgpack`` holds for the
``(generator, discriminator)`` pair: a save resumes in either package
with the same next step.

The file is flax's msgpack state dict: a map ``{'0': {...}, '1': {},
...}`` with one entry per layer, each array a msgpack extension of type
1 holding the msgpack array ``(shape, dtype_name, raw_bytes)``. A small
codec here covers exactly the msgpack subset flax writes (maps, arrays,
str, bin, ext, ints, floats, nil, bool), so neither flax nor the
``msgpack`` package is needed.
"""

import struct

import numpy as np
import torch

#: flax.serialization's msgpack extension code for an ndarray
_EXT_NDARRAY = 1


def params_from_jax(network, params):
    """Load ``params`` (the JAX package's per-layer list, numpy arrays)
    into ``network``'s layers. The network must have been initialized
    for the same input shape (``Network.init``): each loaded array must
    have the shape of the one it replaces. The loaded params land on
    the device of the network's existing params."""
    layers = list(network.layers)
    if len(params) != len(layers):
        raise ValueError(f'{len(params)} param entries for a network of '
                         f'{len(layers)} layers')
    device = next((p.device for p in network.parameters()), None)
    for i, (lyr, p) in enumerate(zip(layers, params)):
        old = {k: tuple(v.shape) for k, v in lyr.named_parameters()}
        lyr.load_jax(p)
        new = {k: tuple(v.shape) for k, v in lyr.named_parameters()}
        if old != new:
            raise ValueError(
                f'layer {i} ({type(lyr).__name__}): checkpoint params '
                f'{new} do not match the initialized network {old}')
    if device is not None:
        network.to(device)
    network.mark_weights_written()
    return network


def chain_params_from_jax(chain, params):
    """Load a ``MultiStepGan``'s generators member by member: ``params``
    holds one JAX per-layer list per member of ``chain.models`` (None for
    a member without a network, e.g. ``LinearInterp``). On disk a chain
    is one ``Sup3rGan`` checkpoint directory per member, which either
    package's ``MultiStepGan.load`` reads. A ``SolarMultiStepGan`` takes
    one such list per group (spatial solar, spatial wind, temporal
    solar)."""
    groups = getattr(chain, 'groups', None)
    if groups is not None:
        if len(params) != len(groups):
            raise ValueError(f'{len(params)} param groups for a chain of '
                             f'{len(groups)} groups')
        for group, group_params in zip(groups, params):
            chain_params_from_jax(group, group_params)
        return chain
    if len(params) != len(chain.models):
        raise ValueError(f'{len(params)} param lists for a chain of '
                         f'{len(chain.models)} members')
    for member, member_params in zip(chain.models, params):
        if member_params is not None:
            params_from_jax(member.generator, member_params)
    return chain


def params_to_jax(network):
    """The JAX package's per-layer param list (numpy float32 arrays in
    its layouts, keys sorted as its checkpoints store them) of
    ``network``'s layers: the inverse of ``params_from_jax``."""
    return [dict(sorted(lyr.params_to_jax().items()))
            for lyr in network.layers]


def _layer_params(network):
    """[(layer, [param names])] in ``network.parameters()`` order."""
    return [(lyr, [n for n, _ in lyr.named_parameters()])
            for lyr in network.layers]


def moments_to_jax(network, tensors):
    """Per-layer state dict (``{'0': {...}, ...}``, numpy arrays in the
    JAX package's layouts) of tensors aligned with
    ``network.parameters()``: optimizer moments shaped like the
    params."""
    it = iter(tensors)
    return {str(i): dict(sorted(lyr.tensors_to_jax(
        {n: next(it) for n in names}).items()))
        for i, (lyr, names) in enumerate(_layer_params(network))}


def moments_from_jax(network, tree):
    """Inverse of ``moments_to_jax``: tensors aligned with
    ``network.parameters()``, each on its parameter's device."""
    params = list(network.parameters())
    out = []
    for i, (lyr, names) in enumerate(_layer_params(network)):
        tensors = lyr.tensors_from_jax(tree[str(i)])
        out.extend(tensors[n] for n in names)
    if len(out) != len(params) or any(
            t.shape != p.shape for t, p in zip(out, params)):
        raise ValueError('optimizer state does not match the network')
    return [t.to(p.device) for t, p in zip(out, params)]


class BF16Array:
    """A bfloat16 array for the checkpoint codec (numpy has no bfloat16):
    its float32 values, which must be bfloat16-exact, written as flax
    writes a ``jnp.bfloat16`` leaf."""

    def __init__(self, values):
        self.values = np.ascontiguousarray(values, np.float32)

    def encode(self):
        bits = (self.values.view(np.uint32) >> 16).astype('<u2')
        return [list(self.values.shape), 'bfloat16', bits.tobytes('C')]


def _bf16_to_float32(buf, shape):
    """float32 values of bfloat16 bytes."""
    bits = np.frombuffer(buf, '<u2').astype(np.uint32) << 16
    return bits.view(np.float32).reshape(shape).copy()


def _moments_to_jax(network, tensors):
    """``moments_to_jax`` that keeps a bfloat16 moment list bfloat16
    (``mu_dtype`` / ``accumulator_dtype``)."""
    if not tensors or tensors[0].dtype != torch.bfloat16:
        return moments_to_jax(network, tensors)
    tree = moments_to_jax(network, [t.float() for t in tensors])
    return {k: {n: BF16Array(a) for n, a in v.items()}
            for k, v in tree.items()}


def opt_state_to_jax(optimizer, state, network):
    """One network's optimizer state as flax's state dict of optax's
    chain state (``{'0': stage, '1': stage, ...}``)."""
    stages = []
    for stage in optimizer.stages(state):
        stages.append({
            k: (np.asarray(v, np.int32) if k == 'count'
                else _moments_to_jax(network, v))
            for k, v in stage.items()})
    return {str(i): st for i, st in enumerate(stages)}


def opt_state_from_jax(optimizer, tree, network):
    """Inverse of ``opt_state_to_jax``: the port's state for
    ``optimizer`` on ``network``'s parameters, each moment list in the
    dtype ``optimizer.init`` gives it."""
    stages = []
    for i in range(len(tree)):
        stages.append({
            k: (int(v) if k == 'count' else moments_from_jax(network, v))
            for k, v in tree[str(i)].items()})
    state = optimizer.from_stages(stages)
    like = optimizer.init(list(network.parameters()))
    for k, v in like.items():
        if isinstance(v, list) and k in state:
            state[k] = [t.to(ref.dtype) for t, ref in zip(state[k], v)]
    return state


# ----------------------------------------------------------------------
# msgpack, the subset flax writes
def _pack(obj, out):
    """Append the msgpack encoding of ``obj`` to the bytearray ``out``
    with the msgpack package's choices: the smallest int and length
    headers, float64 floats, str as str and bytes as bin."""
    if obj is None:
        out += b'\xc0'
    elif obj is True or obj is False:
        out += b'\xc3' if obj else b'\xc2'
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += b'\xcb' + struct.pack('>d', obj)
    elif isinstance(obj, str):
        data = obj.encode('utf-8')
        _pack_len(len(data), out, fix=(0xa0, 32),
                  codes=(0xd9, 0xda, 0xdb))
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(len(obj), out, fix=None, codes=(0xc4, 0xc5, 0xc6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, fix=(0x90, 16), codes=(None, 0xdc, 0xdd))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, fix=(0x80, 16), codes=(None, 0xde, 0xdf))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    elif isinstance(obj, BF16Array):
        inner = bytearray()
        _pack(obj.encode(), inner)
        _pack_ext(_EXT_NDARRAY, bytes(inner), out)
    elif isinstance(obj, np.ndarray):
        # np.ascontiguousarray would make a 0-d array (a count) 1-d
        arr = obj if obj.flags.c_contiguous else np.ascontiguousarray(obj)
        inner = bytearray()
        _pack([list(arr.shape), arr.dtype.name, arr.tobytes('C')], inner)
        _pack_ext(_EXT_NDARRAY, bytes(inner), out)
    else:
        raise TypeError(f'cannot encode {type(obj).__name__} in a '
                        'checkpoint')


def _pack_int(v, out):
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xff)
    elif v >= 0:
        for code, fmt, top in ((0xcc, '>B', 1 << 8), (0xcd, '>H', 1 << 16),
                               (0xce, '>I', 1 << 32),
                               (0xcf, '>Q', 1 << 64)):
            if v < top:
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise OverflowError(v)
    else:
        for code, fmt, low in ((0xd0, '>b', -(1 << 7)),
                               (0xd1, '>h', -(1 << 15)),
                               (0xd2, '>i', -(1 << 31)),
                               (0xd3, '>q', -(1 << 63))):
            if v >= low:
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise OverflowError(v)


def _pack_len(n, out, fix, codes):
    """A container or string header: the fix form below ``fix[1]``,
    else the 8-, 16- or 32-bit length form (``None`` where msgpack has
    none)."""
    if fix is not None and n < fix[1]:
        out.append(fix[0] | n)
        return
    for code, fmt, top in zip(codes, ('>B', '>H', '>I'),
                              (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            out += bytes([code]) + struct.pack(fmt, n)
            return
    raise OverflowError(n)


def _pack_ext(code, data, out):
    n = len(data)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out += bytes([fixed[n], code])
    elif n < 1 << 8:
        out += bytes([0xc7, n, code])
    elif n < 1 << 16:
        out += b'\xc8' + struct.pack('>H', n) + bytes([code])
    else:
        out += b'\xc9' + struct.pack('>I', n) + bytes([code])
    out += data


def packb(obj):
    """msgpack bytes of ``obj`` (dicts, lists, str, bytes, ints, floats,
    None, bools; numpy arrays as flax's ndarray extension)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n):
        chunk = self.data[self.pos:self.pos + n]
        if len(chunk) != n:
            raise ValueError('truncated msgpack data')
        self.pos += n
        return chunk

    def unpack(self, fmt):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def read(self):
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self._map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self._array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), 'utf-8')
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        sized = {0xcc: '>B', 0xcd: '>H', 0xce: '>I', 0xcf: '>Q',
                 0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q',
                 0xca: '>f', 0xcb: '>d'}
        if b in sized:
            return self.unpack(sized[b])
        lengths = {0xd9: '>B', 0xda: '>H', 0xdb: '>I'}
        if b in lengths:
            return str(self.take(self.unpack(lengths[b])), 'utf-8')
        lengths = {0xc4: '>B', 0xc5: '>H', 0xc6: '>I'}
        if b in lengths:
            return bytes(self.take(self.unpack(lengths[b])))
        if b in (0xdc, 0xdd):
            return self._array(self.unpack('>H' if b == 0xdc else '>I'))
        if b in (0xde, 0xdf):
            return self._map(self.unpack('>H' if b == 0xde else '>I'))
        fixed = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixed:
            n = fixed[b]
        elif b in (0xc7, 0xc8, 0xc9):
            n = self.unpack({0xc7: '>B', 0xc8: '>H', 0xc9: '>I'}[b])
        else:
            raise ValueError(f'unsupported msgpack type byte 0x{b:02x} '
                             'in a checkpoint')
        code = self.unpack('>b')
        return self._ext(code, bytes(self.take(n)))

    def _array(self, n):
        return [self.read() for _ in range(n)]

    def _map(self, n):
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    @staticmethod
    def _ext(code, data):
        if code != _EXT_NDARRAY:
            raise ValueError(f'unsupported msgpack extension type {code} '
                             'in a JAX checkpoint')
        shape, dtype, buf = unpackb(data)
        if dtype == 'bfloat16':
            return _bf16_to_float32(buf, shape)
        return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(
            shape).copy()


def unpackb(data):
    """Decode msgpack bytes written by ``packb`` or by flax."""
    reader = _Reader(data)
    obj = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError('trailing bytes after a msgpack object')
    return obj


def load_jax_checkpoint(path):
    """Per-layer param list (numpy arrays) from a JAX network
    checkpoint."""
    with open(path, 'rb') as f:
        tree = unpackb(f.read())
    if not isinstance(tree, dict) or set(tree) != {
            str(i) for i in range(len(tree))}:
        raise ValueError(f'{path} is not a per-layer network checkpoint')
    return [tree[str(i)] for i in range(len(tree))]


def _state_dict(tree):
    """flax's state dict of a params tree as the JAX package's
    ``save_network_params`` builds it: dict keys as strings in sorted
    order (``jax.tree.map`` sorts them), lists and tuples as maps keyed
    '0', '1', ..., tensors and other leaves as numpy arrays (bfloat16
    tensors as flax's bfloat16 leaves)."""
    if isinstance(tree, dict):
        return {str(k): _state_dict(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu()
        if tree.dtype == torch.bfloat16:
            return BF16Array(tree.float().numpy())
        return tree.numpy()
    return None if tree is None else np.asarray(tree)


def restore_state_dict(template, state, path='.'):
    """``flax.serialization.from_state_dict`` for the trees params are
    made of: ``template``'s structure (dicts, lists, tuples) filled with
    ``state``'s leaves, with flax's errors and their text when a list's
    length differs or a template key is missing from the state."""
    if isinstance(template, dict):
        diff = set(map(str, template.keys())).difference(state.keys())
        if diff:
            raise ValueError(
                'The target dict keys and state dict keys do not match, '
                f'target dict contains keys {diff} which are not present '
                f'in state dict at path {path}')
        return {key: restore_state_dict(value, state[str(key)],
                                        f'{path}/{key}')
                for key, value in template.items()}
    if isinstance(template, (list, tuple)):
        if len(state) != len(template):
            raise ValueError(
                'The size of the list and the state dict do not match, '
                f'got {len(template)} and {len(state)} at path {path}')
        out = [restore_state_dict(x, state[str(i)], f'{path}/{i}')
               for i, x in enumerate(template)]
        return tuple(out) if isinstance(template, tuple) else out
    return state


def save_jax_checkpoint(params, path):
    """Write a params tree (a per-layer param list for a network) as
    flax's state dict, byte for byte as the JAX package writes the same
    params."""
    with open(path, 'wb') as f:
        f.write(packb(_state_dict(params)))
