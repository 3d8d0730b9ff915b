"""The public surface of ``bp_osd_tpu_torch`` covers ``bp_osd_tpu``'s.

Both packages are parsed with ``ast``; neither is imported.  For every module
of the JAX package, the port's module of the same path must exist and hold
each public name the JAX module defines (functions, classes and assignments
at module level, and a package ``__init__``'s ``__all__``; a name a module
only imports is the other module's).  For a function, every argument of the
JAX function must be an argument of the port's; for a class, every public
method and ``__init__`` must exist with every argument, and every annotated
field (a ``NamedTuple``'s) too.  What the port leaves out on purpose is in
the allow-lists below, each entry with its reason.  The root scripts in
``examples/`` are held the same way against ``bp_osd_tpu_torch/examples/``:
a module of the same name, with each public function and its arguments.
"""

import ast
import copy
import fnmatch
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = "bp_osd_tpu", "bp_osd_tpu_torch"

# arguments the port drops wherever the JAX package has them
ALLOWED_ARGS = {
    "interpret": "TPU-only: runs a Pallas kernel in interpret mode; the port's kernels are "
                 "CUDA and CPU tensors take the plain torch versions",
    "bp_operators": "TPU-only: the one-hot routing operators of the Pallas BP "
                    "(ops/pallas_bp.py:build_bp_operators); K1 walks the Tanner tables",
    "bp_block": "TPU-only: the Pallas BP's block of samples on the lanes; K1 plans its "
                "own teams (bp_flood_plan)",
    "bp_msg_dtype": "TPU-only: the MXU routing dtype of the Pallas BP "
                    "(ops/pallas_bp.py:141); K1 adds in float32",
}
# class members the port drops, as (module, "Class.member")
ALLOWED_MEMBERS = {
    ("decoder/tanner.py", "TannerGraph.tree_flatten"): "jax pytree protocol; torch has none",
    ("decoder/tanner.py", "TannerGraph.tree_unflatten"): "jax pytree protocol; torch has none",
}
# modules of the JAX package that have no counterpart of the same path
ALLOWED_MODULES = {
    "ops/pallas_*.py": "the Pallas kernels, replaced by the CUDA ones in ops/cuda_*.py",
    "native/*": "the framework-neutral C++ baseline, which stays with the reference",
}


def _modules(pkg):
    out = {}
    base = os.path.join(ROOT, pkg)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(d, f)
                with open(path) as fh:
                    out[os.path.relpath(path, base)] = ast.parse(fh.read(), path)
    return out


def _allowed_module(rel):
    return any(fnmatch.fnmatch(rel, pat) for pat in ALLOWED_MODULES)


def _imported_from(tree):
    """Each name a module imports, with the module path it comes from
    (relative imports resolved against nothing: ``.pallas_bp`` stays so)."""
    names = {}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            for a in node.names:
                names[a.asname or a.name] = "." * node.level + (node.module or "")
    return names


def _public(tree, rel):
    """The module's public names and their nodes: its own definitions, and in
    a package ``__init__`` the names of ``__all__`` (re-exports), except
    those re-exported from an allow-listed module."""
    defined, exported = {}, []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            defined[node.name] = node
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    defined[t.id] = node
                    if t.id == "__all__":
                        exported = [e.value for e in node.value.elts]
    public = {k: v for k, v in defined.items() if not k.startswith("_")}
    if os.path.basename(rel) == "__init__.py":
        src = _imported_from(tree)
        pkg_dir = os.path.dirname(rel)
        for name in exported:
            origin = src.get(name, "")
            target = os.path.join(pkg_dir, origin.lstrip(".").replace(".", "/") + ".py")
            if name not in public and not _allowed_module(os.path.normpath(target)):
                public[name] = None
    return public


def _names(tree):
    """Every name the module binds at top level, imports included."""
    names = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names[node.name] = node
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names[t.id] = node
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names[node.target.id] = node
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                names[(a.asname or a.name).split(".")[0]] = node
    return names


def _args(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return names + [x.arg for x in (a.vararg, a.kwarg) if x is not None]


def _missing_args(jfn, pfn, what):
    return [f"{what}: argument {arg!r}" for arg in _args(jfn)
            if arg not in _args(pfn) and arg not in ALLOWED_ARGS]


def _members(cls):
    funcs = {n.name: n for n in cls.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    fields = {n.target.id for n in cls.body
              if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name)}
    return funcs, fields


def gaps(rel, jtree, ptree):
    """What the port's module ``rel`` (``ptree``, or None where it has no
    such module) lacks of the JAX module's public surface."""
    if _allowed_module(rel):
        return []
    if ptree is None:
        return [f"{rel}: no module {PORT_PKG}/{rel}"]
    found = []
    pnames = _names(ptree)
    for name, jnode in _public(jtree, rel).items():
        if name not in pnames:
            found.append(f"{rel}: no public name {name!r}")
            continue
        pnode = pnames[name]
        if isinstance(jnode, ast.FunctionDef) and isinstance(pnode, ast.FunctionDef):
            found += _missing_args(jnode, pnode, f"{rel}:{name}")
        elif isinstance(jnode, ast.ClassDef) and isinstance(pnode, ast.ClassDef):
            jfuncs, jfields = _members(jnode)
            pfuncs, pfields = _members(pnode)
            for fname, jf in jfuncs.items():
                if fname.startswith("_") and fname != "__init__":
                    continue
                member = f"{name}.{fname}"
                if (rel, member) in ALLOWED_MEMBERS:
                    continue
                if fname not in pfuncs:
                    found.append(f"{rel}: no method {member}")
                else:
                    found += _missing_args(jf, pfuncs[fname], f"{rel}:{member}")
            found += [f"{rel}: no field {name}.{f}" for f in sorted(jfields - pfields)
                      if not f.startswith("_")]
    return found


JAX_MODULES = _modules(JAX_PKG)
PORT_MODULES = _modules(PORT_PKG)
JAX_EXAMPLES = {rel: tree for rel, tree in _modules("examples").items() if "/" not in rel}


def example_gaps(name, jtree, ptree):
    """What the port's example ``name`` (``ptree``, or None where it has no
    such module) lacks of the root script's public functions."""
    if ptree is None:
        return [f"examples/{name}: no module {PORT_PKG}/examples/{name}"]
    pnames = _names(ptree)
    found = []
    for node in jtree.body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            pnode = pnames.get(node.name)
            if not isinstance(pnode, ast.FunctionDef):
                found.append(f"examples/{name}: no function {node.name!r}")
            else:
                found += _missing_args(node, pnode, f"examples/{name}:{node.name}")
    return found


@pytest.mark.parametrize("rel", sorted(JAX_MODULES))
def test_port_covers_the_module(rel):
    """Each module of the JAX package: its counterpart holds every public
    name, argument, method and field, but for the allow-lists."""
    assert gaps(rel, JAX_MODULES[rel], PORT_MODULES.get(rel)) == []


@pytest.mark.parametrize("name", sorted(JAX_EXAMPLES))
def test_port_has_each_example(name):
    """Each root ``examples/*.py``: ``bp_osd_tpu_torch/examples/`` has a
    module of that name with every public function and argument."""
    assert example_gaps(name, JAX_EXAMPLES[name], PORT_MODULES.get(f"examples/{name}")) == []


def test_a_missing_example_or_argument_is_found():
    """The check fails on the port without ``generate_hgp_codes`` (the port
    before it had one) and on a ``generate`` without ``out_dir``."""
    name = "generate_hgp_codes.py"
    assert example_gaps(name, JAX_EXAMPLES[name], None) == [
        f"examples/{name}: no module {PORT_PKG}/examples/{name}"]
    tree = _without(PORT_MODULES[f"examples/{name}"], "generate", "out_dir")
    assert example_gaps(name, JAX_EXAMPLES[name], tree) == [
        f"examples/{name}:generate: argument 'out_dir'"]
    tree = copy.deepcopy(PORT_MODULES[f"examples/{name}"])
    tree.body = [n for n in tree.body
                 if not (isinstance(n, ast.FunctionDef) and n.name == "generate")]
    assert example_gaps(name, JAX_EXAMPLES[name], tree) == [
        f"examples/{name}: no function 'generate'"]


def test_every_allow_list_entry_is_used():
    """No stale entry: each allowed argument and member is one the JAX
    package has and the port lacks, and each allowed module pattern names
    JAX modules with no counterpart of the same path."""
    jax_args, port_args = set(), set()
    for rel, tree in JAX_MODULES.items():
        if not _allowed_module(rel):
            jax_args |= {a for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
                         for a in _args(n)}
    for tree in PORT_MODULES.values():
        port_args |= {a for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
                      for a in _args(n)}
    for arg in ALLOWED_ARGS:
        assert arg in jax_args and arg not in port_args, arg
    for (rel, member) in ALLOWED_MEMBERS:
        cls, fname = member.split(".")
        jfuncs, _ = _members(_names(JAX_MODULES[rel])[cls])
        pfuncs, _ = _members(_names(PORT_MODULES[rel])[cls])
        assert fname in jfuncs and fname not in pfuncs, member
    for pat in ALLOWED_MODULES:
        matched = [rel for rel in JAX_MODULES if fnmatch.fnmatch(rel, pat)]
        assert matched and not any(rel in PORT_MODULES for rel in matched), pat
    assert set(ALLOWED_ARGS) == {"interpret", "bp_operators", "bp_block", "bp_msg_dtype"}


def _without(tree, fname, arg):
    """A copy of ``tree`` whose function ``fname`` lacks the argument ``arg``."""
    tree = copy.deepcopy(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == fname:
            a = node.args
            keep = [i for i, x in enumerate(a.kwonlyargs) if x.arg != arg]
            a.kwonlyargs = [a.kwonlyargs[i] for i in keep]
            a.kw_defaults = [a.kw_defaults[i] for i in keep]
            a.args = [x for x in a.args if x.arg != arg]
    return tree


@pytest.mark.parametrize("rel, fname, arg, want", [
    ("decoder/pipeline.py", "decode_pipeline", "stage1_iters",
     "decoder/pipeline.py:decode_pipeline: argument 'stage1_iters'"),
    ("decoder/bposd.py", "__init__", "channel_probs",
     "decoder/bposd.py:BpOsdDecoder.__init__: argument 'channel_probs'"),
    ("decoder/osd.py", "osd_decode", "osd_order",
     "decoder/osd.py:osd_decode: argument 'osd_order'"),
])
def test_a_dropped_argument_is_found(rel, fname, arg, want):
    """The check fails on a port module with one argument taken away (the
    port before ``stage1_iters``, for one)."""
    assert gaps(rel, JAX_MODULES[rel], PORT_MODULES[rel]) == []
    found = gaps(rel, JAX_MODULES[rel], _without(PORT_MODULES[rel], fname, arg))
    assert want in found


def test_a_dropped_name_method_or_module_is_found():
    rel = "decoder/pipeline.py"
    tree = copy.deepcopy(PORT_MODULES[rel])
    tree.body = [n for n in tree.body
                 if not (isinstance(n, ast.FunctionDef) and n.name == "auto_stage_schedule")]
    assert f"{rel}: no public name 'auto_stage_schedule'" in gaps(rel, JAX_MODULES[rel], tree)
    rel = "decoder/tanner.py"
    tree = copy.deepcopy(PORT_MODULES[rel])
    for n in tree.body:
        if isinstance(n, ast.ClassDef) and n.name == "TannerGraph":
            n.body = [m for m in n.body if not (isinstance(m, ast.FunctionDef)
                                                and m.name == "__init__")]
    assert f"{rel}: no method TannerGraph.__init__" in gaps(rel, JAX_MODULES[rel], tree)
    assert gaps("sim/css_decode_sim.py", JAX_MODULES["sim/css_decode_sim.py"], None) == [
        f"sim/css_decode_sim.py: no module {PORT_PKG}/sim/css_decode_sim.py"]
    assert gaps("ops/pallas_bp.py", JAX_MODULES["ops/pallas_bp.py"], None) == []


def test_neither_package_is_imported():
    """The parsed sources are the packages' files; this module imports
    neither package."""
    with open(os.path.abspath(__file__)) as f:
        tree = ast.parse(f.read())
    roots = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    roots |= {(n.module or "").split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert not roots & {JAX_PKG, PORT_PKG, "jax", "torch"}
    assert "decoder/pipeline.py" in JAX_MODULES and "decoder/pipeline.py" in PORT_MODULES
