"""The port's public surface is closed against the JAX package's.

Every ``.py`` file under ``sup3r_tpu/`` is read as an AST (nothing is
imported, so the walk takes well under a second). Each public item it
defines -- a module-level function, class or constant, and a class's
method or property -- must have a counterpart of the same name in the
same-named module of ``sup3r_tpu_torch/`` (or the module ``MOVES`` maps it
to): defined there, imported there, or, for a member, defined on the
port class or on one of its bases in the port. Every argument name of a
JAX function or method, ``__init__`` included, must be in its
counterpart's signature, and a JAX property must stay an attribute.
The JAX positional parameters must sit at the same positions in the
port's, so a call written for JAX binds its arguments as JAX does; a
signature that breaks this is reported as ``'module:Qual.name[positions]'``.
A package ``__init__.py`` re-exports count as its items.

``ALLOWLIST`` names what the port leaves out on purpose. Its only grounds
are JAX's runtime: a jitted callable, a params pytree or PRNG key passed
as an argument (the port's modules own their weights and generators), a
compiled program, click's ``ctx``, or a number taken for a TPU. A key is
``'module:Qual.name'`` for an item, ``'module:Qual.name(arg)'`` for an
argument or ``'module:Qual.name[positions]'`` for the order of the
positional parameters; its value names the port's counterpart and the reason.
``test_allowlist_is_not_stale`` fails when an entry names something the
JAX package no longer has, or that the port now has.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DIR = os.path.join(ROOT, 'sup3r_tpu')
PORT_DIR = os.path.join(ROOT, 'sup3r_tpu_torch')

#: JAX module -> the port module that holds its names
MOVES = {'ops/pallas_kernels.py': 'ops/kernels.py'}

_CLICK = "click's ctx; port: argparse, the command reads its config_file"
_KEY = 'PRNG key; port: layers draw from a torch.Generator they are given'
_KEY_FIRST = 'PRNG key first; port: init(in_shape, generator)'

ALLOWLIST = {
    # click's runtime
    'cli.py:main(ctx)': "click's ctx; port: main(argv) returns the exit code",
    'cli.py:main(config_file)': 'click option -c; port: main(argv) parses -c',
    'cli.py:main(verbose)': 'click option -v; port: main(argv) parses -v',
    'cli.py:forward_pass(ctx)': _CLICK,
    'cli.py:solar(ctx)': _CLICK,
    'cli.py:bias_calc(ctx)': _CLICK,
    'cli.py:data_collect(ctx)': _CLICK,
    'cli.py:qa(ctx)': _CLICK,
    'cli.py:pipeline(ctx)': _CLICK,
    'cli.py:batch(ctx)': _CLICK,
    # params pytrees and kernels passed as arguments
    'ops/conv_ad.py:reflect_conv_ad(kernel)':
        'kernel array; port: reflect_conv_ad(x, weight, ...)',
    'ops/conv_ad.py:reflect_conv_shard_aligned(kernel)':
        'kernel array; port: reflect_conv_shard_aligned(x, weight, ...)',
    'ops/pallas_kernels.py:reflect_conv_reference(kernel)':
        'kernel array; port: reflect_conv_reference(x, weight, ...)',
    'ops/subpixel.py:build_subpixel_kernel(kernel)':
        'kernel array; port: build_subpixel_kernel(weight, ...)',
    'ops/subpixel.py:subpixel_tail_conv(kernel)':
        'kernel array; port: subpixel_tail_conv(z, weight, ...)',
    'ops/subpixel.py:subpixel_tail_conv(precision)':
        "lax.Precision for the TPU's MXU; port: exact_fp32 sets the convs'"
        ' precision',
    'models/fuse.py:fuse_network(params)':
        'params pytree; port: the network owns its params',
    'models/fuse.py:fuse_subpixel_tail(params)':
        'params pytree; port: the network owns its params',
    'models/network.py:Network.apply(params)':
        'params pytree; port: Network.apply reads the modules\' params',
    'models/network.py:Network.apply(dropout_key)':
        'PRNG key; port: Network.apply(dropout_generator=)',
    'models/network.py:Network.apply[positions]':
        'params pytree first; port: Network.apply(x, exo, train, ...)',
    'models/fuse.py:FusedReflectConv.__init__[positions]':
        'the port layer holds its conv: FusedReflectConv(n_spatial, conv,'
        ' alpha)',
    'models/fuse.py:SubpixelTailConv.__init__[positions]':
        'the port layer holds its tail block: SubpixelTailConv(m, tail,'
        ' alpha_prev)',
    'models/fuse.py:SubpixelTailConv.__init__(alpha)':
        "the tail's slope; port: the held tail block's alpha",
    'models/layers.py:Layer.apply':
        'functional apply(params, x); port: Layer.forward on owned params',
    'models/layers.py:Activation.apply': 'functional apply; port: forward',
    'models/layers.py:LeakyReLU.apply': 'functional apply; port: forward',
    'models/layers.py:Dropout.apply': 'functional apply; port: forward',
    'models/layers.py:Flatten.apply': 'functional apply; port: forward',
    'models/layers.py:Dense.apply': 'functional apply; port: forward',
    'models/layers.py:FlexiblePadding.apply':
        'functional apply; port: forward',
    'models/layers.py:SpatialExpansion.apply':
        'functional apply; port: forward',
    'models/layers.py:SpatioTemporalExpansion.apply':
        'functional apply; port: forward',
    'models/layers.py:SkipConnection.apply': 'functional apply; port: forward',
    'models/layers.py:Sup3rAdder.apply': 'functional apply; port: forward',
    'models/layers.py:Sup3rConcat.apply': 'functional apply; port: forward',
    'models/layers.py:Sup3rConcatObs.apply':
        'functional apply; port: forward',
    'models/layers.py:Sup3rObsModel.apply':
        'functional apply; port: forward',
    'models/fuse.py:FusedReflectConv.apply':
        'functional apply; port: FusedReflectConv.forward',
    'models/fuse.py:SubpixelTailConv.apply':
        'functional apply; port: SubpixelTailConv.forward',
    'models/layers.py:Layer.init(key)': _KEY,
    'models/layers.py:Dense.init(key)': _KEY,
    'models/layers.py:Sup3rObsModel.init(key)': _KEY,
    'models/network.py:Network.init(key)': _KEY,
    'models/layers.py:Layer.init[positions]': _KEY_FIRST,
    'models/layers.py:Dense.init[positions]': _KEY_FIRST,
    'models/layers.py:Sup3rObsModel.init[positions]': _KEY_FIRST,
    'models/network.py:Network.init[positions]': _KEY_FIRST,
    'ops/losses.py:apply_loss(key)':
        'PRNG key; port: apply_loss(generator=) draws from a torch.Generator',
    'ops/losses.py:SlicedWassersteinLoss.needs_key':
        'asks for a PRNG key; port: needs_generator asks for a generator',
    'models/fuse.py:SubpixelTailConv.precision':
        "lax.Precision for the TPU's MXU; port: exact_fp32 sets the convs'"
        ' precision',
    # jitted callables and compiled programs
    'models/gan.py:Sup3rGan.train_step_fn':
        'jitted step; port: Sup3rGan._train_step',
    'models/gan.py:Sup3rGan.sample_train_step_fn':
        'jitted step on a raw sample; port: run_gradient_descent_on_sample',
    'models/conditional.py:Sup3rCondMom.train_step_fn':
        'jitted step; port: Sup3rCondMom._train_step',
    'parallel/mesh.py:halo_bytes_from_compiled(compiled)':
        'compiled SPMD program; port: (mesh) reads Mesh.counters',
    'parallel/mesh.py:allreduce_bytes_from_compiled(compiled)':
        'compiled SPMD program; port: (mesh) reads Mesh.counters',
    # numbers taken for a TPU
    'pipeline/memory.py:DEFAULT_HBM_BYTES':
        'a v5e HBM size; port: sizes from torch.cuda.mem_get_info',
}


def _parse(path):
    with open(path) as f:
        return ast.parse(f.read(), filename=path)


def _top_statements(body):
    """Module-level statements, with those under ``if`` / ``try``."""
    for s in body:
        if isinstance(s, (ast.If, ast.Try)):
            yield from _top_statements(s.body)
            for h in getattr(s, 'handlers', ()):
                yield from _top_statements(h.body)
            yield from _top_statements(s.orelse)
            yield from _top_statements(getattr(s, 'finalbody', ()))
        else:
            yield s


def _assigned(s):
    if isinstance(s, ast.Assign):
        for t in s.targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    yield n.id
    elif isinstance(s, ast.AnnAssign) and isinstance(s.target, ast.Name):
        yield s.target.id


def _imported(s):
    if isinstance(s, (ast.Import, ast.ImportFrom)):
        for a in s.names:
            yield (a.asname or a.name).split('.')[0]


def _is_function(node):
    return isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))


def _is_property(node):
    return _is_function(node) and any(
        ast.unparse(d).endswith(('property', '.getter'))
        for d in node.decorator_list)


class Module:
    """One module's items from its AST: ``defs`` (name -> def, class or
    assignment node) and ``imports`` (name -> the ImportFrom node)."""

    def __init__(self, rel, path):
        self.rel = rel
        tree = _parse(path)
        self.defs, self.imports = {}, {}
        for s in _top_statements(tree.body):
            if _is_function(s) or isinstance(s, ast.ClassDef):
                self.defs[s.name] = s
            for n in _assigned(s):
                self.defs.setdefault(n, s)
            if isinstance(s, ast.ImportFrom):
                for a in s.names:
                    self.imports[a.asname or a.name] = s
            for n in _imported(s):
                self.imports.setdefault(n, s)

    def public_items(self, package):
        """Public names this module defines; a package ``__init__``'s
        re-exports from its own package count too."""
        names = {n: node for n, node in self.defs.items()
                 if not n.startswith('_') and n not in self.imports}
        if self.rel.endswith('__init__.py'):
            for n, s in self.imports.items():
                if (not n.startswith('_') and isinstance(s, ast.ImportFrom)
                        and (s.level or (s.module or '').split('.')[0]
                             == package)):
                    names.setdefault(n, s)
        return names


class Tree:
    """A package's modules, read on demand, with class lookup across its
    imports."""

    def __init__(self, root, package):
        self.root, self.package, self._mods = root, package, {}

    def module(self, rel):
        if rel not in self._mods:
            path = os.path.join(self.root, rel)
            self._mods[rel] = Module(rel, path) if os.path.isfile(
                path) else None
        return self._mods[rel]

    def _source_of(self, rel, imp):
        """The package module an ImportFrom in ``rel`` reads, or None."""
        if imp.level:
            parts = rel.split('/')[:-1]
            parts = parts[:len(parts) - imp.level + 1]
            mod = parts + ((imp.module or '').split('.') if imp.module
                           else [])
        elif (imp.module or '').split('.')[0] == self.package:
            mod = imp.module.split('.')[1:]
        else:
            return None
        for cand in ('/'.join(mod) + '.py', '/'.join(mod + ['__init__.py'])):
            if self.module(cand.lstrip('/')) is not None:
                return cand.lstrip('/')
        return None

    def lookup(self, rel, name, depth=0):
        """(module rel, node) that defines ``name`` as seen from ``rel``,
        following ``from ... import`` inside the package; None if the
        name is not bound there; (rel, None) if bound by an outside
        import."""
        mod = self.module(rel)
        if mod is None or depth > 8:
            return None
        if name in mod.defs and name not in mod.imports:
            return rel, mod.defs[name]
        imp = mod.imports.get(name)
        if imp is None:
            return (rel, mod.defs[name]) if name in mod.defs else None
        if isinstance(imp, ast.ImportFrom):
            src = self._source_of(rel, imp)
            if src is not None:
                orig = next((a.name for a in imp.names
                             if (a.asname or a.name) == name), name)
                found = self.lookup(src, orig, depth + 1)
                if found is not None:
                    return found
        return rel, None

    def members(self, rel, cls, seen=None):
        """name -> node for a class's members: its body's defs and
        assignments, ``self.<name>`` stores (node None), then its bases'
        members within the package."""
        seen = set() if seen is None else seen
        if (rel, cls.name) in seen:
            return {}
        seen.add((rel, cls.name))
        out = {}
        for s in cls.body:
            if _is_function(s):
                out[s.name] = s
            for n in _assigned(s):
                out.setdefault(n, s)
        for n in ast.walk(cls):
            if (isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Store)
                    and isinstance(n.value, ast.Name)
                    and n.value.id == 'self'):
                out.setdefault(n.attr, None)
        for base in cls.bases:
            bname = ast.unparse(base).split('.')[-1]
            found = self.lookup(rel, bname)
            if found and isinstance(found[1], ast.ClassDef):
                for k, v in self.members(found[0], found[1], seen).items():
                    out.setdefault(k, v)
        return out


def _arg_names(fn):
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]


def _positional(fn):
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args
            if x.arg not in ('self', 'cls')]


def _misplaced(jax_fn, port_fn):
    """True when a JAX positional parameter the port also takes sits at
    another position (or is keyword-only) in the port's signature."""
    have, port_pos = set(_arg_names(port_fn)), _positional(port_fn)
    return any(n in have and port_pos[i:i + 1] != [n]
               for i, n in enumerate(_positional(jax_fn)))


def _missing_args(jax_fn, port_fn):
    """JAX argument names the port's signature lacks. ``*args`` and
    ``**kwargs`` are no names a caller passes, so they are not
    compared."""
    have = set(_arg_names(port_fn))
    return [n for n in _arg_names(jax_fn)
            if n not in have and n not in ('self', 'cls')]


JAX = Tree(JAX_DIR, 'sup3r_tpu')
PORT = Tree(PORT_DIR, 'sup3r_tpu_torch')


def _jax_modules():
    out = []
    for dirpath, _, files in os.walk(JAX_DIR):
        for fn in files:
            if fn.endswith('.py'):
                out.append(os.path.relpath(os.path.join(dirpath, fn),
                                           JAX_DIR).replace(os.sep, '/'))
    return sorted(out)


def _compare_function(key, jax_fn, port_fn):
    if not (_is_function(jax_fn) and _is_function(port_fn)):
        return []
    if _is_property(jax_fn) and not _is_property(port_fn):
        return [f'{key} is a property in JAX, a method in the port']
    out = [f'{key}({a})' for a in _missing_args(jax_fn, port_fn)]
    if _misplaced(jax_fn, port_fn):
        out.append(f'{key}[positions]')
    return out


def gaps(rel):
    """Every item of JAX module ``rel`` the port lacks, as keys in the
    allowlist's form."""
    port_rel = MOVES.get(rel, rel)
    jmod = JAX.module(rel)
    if PORT.module(port_rel) is None:
        return [f'{rel}:<module>']
    out = []
    for name, node in sorted(jmod.public_items('sup3r_tpu').items()):
        key = f'{rel}:{name}'
        found = PORT.lookup(port_rel, name)
        if found is None:
            out.append(key)
            continue
        pnode = found[1]
        out += _compare_function(key, node, pnode)
        if not isinstance(node, ast.ClassDef):
            continue
        if not isinstance(pnode, ast.ClassDef):
            out.append(f'{key} is a class in JAX only')
            continue
        pmembers = PORT.members(found[0], pnode)
        jmembers = {s.name: s for s in node.body if _is_function(s)}
        for s in node.body:
            for n in _assigned(s):
                jmembers.setdefault(n, s)
        for mname, mnode in sorted(jmembers.items()):
            mkey = f'{key}.{mname}'
            if mname == '__init__' and '__init__' in pmembers:
                out += _compare_function(mkey, mnode, pmembers['__init__'])
            if mname.startswith('_'):
                continue
            if mname not in pmembers:
                out.append(mkey)
                continue
            pm = pmembers[mname]
            if pm is None or not _is_function(pm):
                if _is_function(mnode) and not _is_property(mnode):
                    out.append(f'{mkey} is a method in JAX, an attribute '
                               'in the port')
                continue
            out += _compare_function(mkey, mnode, pm)
    return out


@pytest.mark.parametrize('module', _jax_modules())
def test_port_has_every_public_name(module):
    """Each public item of the JAX module, and each of its argument
    names, has its counterpart in the port or an allowlist entry."""
    left = [g for g in gaps(module) if g not in ALLOWLIST]
    assert not left, f'{module}: the port lacks {left}'


def test_allowlist_is_not_stale():
    """Each entry names an item or argument the JAX package still has and
    the port still lacks, with a one-line reason."""
    all_gaps = {g for m in _jax_modules() for g in gaps(m)}
    stale = []
    for key, why in ALLOWLIST.items():
        rel, _, item = key.partition(':')
        assert why and '\n' not in why, key
        if not os.path.isfile(os.path.join(JAX_DIR, rel)):
            stale.append(f'{key}: no such JAX module')
            continue
        base = item.split('(')[0].split('[')[0]
        qual = base.split('.')
        node = JAX.module(rel).public_items('sup3r_tpu').get(qual[0])
        if node is not None and len(qual) > 1:
            node = next((s for s in node.body if qual[1] == getattr(
                s, 'name', None) or qual[1] in _assigned(s)),
                None) if isinstance(node, ast.ClassDef) else None
        if node is None:
            stale.append(f'{key}: the JAX package has no {base}')
        elif '(' in item and item[len(base) + 1:-1] not in (
                _arg_names(node) if _is_function(node) else ()):
            stale.append(f'{key}: JAX {base} takes no such argument')
        elif item.endswith('[positions]') and not _is_function(node):
            stale.append(f'{key}: JAX {base} is no function')
        elif key not in all_gaps:
            stale.append(f'{key}: the port has it now')
    assert not stale, stale
