"""Weights carried across from the JAX package.

``params_from_jax`` loads the JAX package's per-layer param list
(``[{}, {'kernel': DHWIO, 'bias': ...}, ...]`` of numpy arrays) into the
port's layer modules; ``load_jax_checkpoint`` reads a
``model_gen.msgpack`` / ``model_disc.msgpack`` that ``Sup3rGan.save``
wrote, without flax.

The file is flax's msgpack state dict: a map ``{'0': {...}, '1': {},
...}`` with one entry per layer, each array a msgpack extension of type
1 holding ``(shape, dtype_name, raw_bytes)``.
"""

import numpy as np

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
    return network


def _ext_hook(code, data):
    import msgpack

    if code != _EXT_NDARRAY:
        raise ValueError(f'unsupported msgpack extension type {code} in a '
                         'JAX checkpoint')
    shape, dtype, buf = msgpack.unpackb(data, raw=False)
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()


def load_jax_checkpoint(path):
    """Per-layer param list (numpy arrays) from a JAX network
    checkpoint. ``msgpack`` is imported here only: the serving path
    from a port-initialized model never needs it."""
    import msgpack

    with open(path, 'rb') as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False,
                               strict_map_key=False)
    if not isinstance(tree, dict) or set(tree) != {
            str(i) for i in range(len(tree))}:
        raise ValueError(f'{path} is not a per-layer network checkpoint')
    return [tree[str(i)] for i in range(len(tree))]
