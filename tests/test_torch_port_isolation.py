"""horovod_tpu_torch stands alone: importing it loads neither jax nor
horovod_tpu, no file of it (nor chip_smoke.py) imports them, and its
copies of the framework-neutral modules (and of the C++ control core's
sources) stay the reference's bytes but for a declared list of
differences, and the K1/K2 sources cite the reference's functions at
the lines that define them."""

import ast
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "horovod_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "horovod_tpu")

# module -> [(reference text, port text)]: applying every replacement
# to the reference file must give the port's file exactly.
DECLARED = {
    "common/logging.py": [],
    "ops/order_check.py": [],
    "common/exceptions.py": [],
    "metrics.py": [],
    "faults.py": [],
    "journal.py": [],
    "telemetry.py": [],
    "common/config.py": [
        ('"""Central configuration registry for horovod_tpu.\n',
         '"""Central configuration registry for horovod_tpu.\n\n'
         "Port copy (horovod_tpu_torch): the same knobs, types and "
         "defaults as\nthe JAX package's registry. Deliberate "
         "differences, each pinned by\ntests/test_torch_port_"
         "isolation.py: this paragraph; the doc of\n"
         "HOROVOD_FLASH_ATTENTION, which here says the port does not "
         "read it; and\nthe registry path named in the unknown-knob "
         "errors.\n"),
        ('''\
         "Pallas flash-attention kernel inside ring attention: '1' "
         "forces it, 'auto' tries it for supported shapes, '0' "
         "(default) keeps the jnp path (measured SLOWER inside the "
         "remat'd layer scan — see docs/benchmarks.md)."),''',
         '''\
         "Read by the JAX package only: the port's attention launches "
         "its CUDA flash-attention kernel (ops/flash_attention.py) for "
         "every CUDA tensor and takes the plain PyTorch path for CPU "
         "tensors, whatever this knob says."),'''),
        ('f"KNOBS in horovod_tpu/common/config.py")',
         'f"KNOBS in horovod_tpu_torch/common/config.py")'),
    ],
    "ops/bucketing.py": [
        ('''\
"""Shared gradient-bucketing layer: deterministic reverse-order
packing of pytree leaves into `HOROVOD_FUSION_THRESHOLD`-sized buckets.
''',
         '''\
"""Shared gradient-bucketing layer: deterministic reverse-order
packing of pytree leaves into `HOROVOD_FUSION_THRESHOLD`-sized buckets.

Port copy (horovod_tpu_torch): byte-identical to the JAX package's
module but for this paragraph, `leaf_nbytes` and `dtype_name`, which
size torch tensors, numpy arrays and dtype names ("bfloat16"
included) without ml_dtypes, `partition_tree`, which flattens a port
tree instead of importing jax, and `split_by_dtype`, which keys on
the normalised dtype name, so a torch bucket splits as the
reference's does (pinned by tests/test_torch_port_isolation.py).
'''),
        ('''\
def leaf_nbytes(leaf: Any) -> int:
    """Raw payload bytes of one array-like leaf (shape x itemsize;
    scalars count their itemsize)."""
    shape = getattr(leaf, "shape", ())
    size = int(np.prod(shape)) if shape else 1
    return size * np.dtype(leaf.dtype).itemsize
''',
         '''\
def dtype_name(dtype: Any) -> str:
    """The numpy-style name of a torch, numpy or jax dtype, or of a
    dtype name: torch.bfloat16, "torch.bfloat16" and "bfloat16" are
    all "bfloat16" (the reference's ``str(leaf.dtype)``)."""
    name = str(dtype)
    return name[len("torch."):] if name.startswith("torch.") else name


def leaf_nbytes(leaf: Any) -> int:
    """Raw payload bytes of one array-like leaf (shape x itemsize;
    scalars count their itemsize)."""
    shape = getattr(leaf, "shape", ())
    size = int(np.prod(shape)) if shape else 1
    name = dtype_name(leaf.dtype)
    return size * (2 if name == "bfloat16" else np.dtype(name).itemsize)
'''),
        ('''\
    """`partition_buckets` over a pytree's flattened leaves (indices
    refer to `jax.tree_util.tree_leaves(tree)` order)."""
    import jax
    return partition_buckets(jax.tree_util.tree_leaves(tree),
                             threshold_bytes, key_fn)
''',
         '''\
    """`partition_buckets` over a port tree's flattened leaves
    (indices refer to `tree_leaves(tree)` order)."""
    return partition_buckets(tree_leaves(tree), threshold_bytes, key_fn)


def tree_leaves(tree: Any) -> List[Any]:
    """A port tree's leaves in `jax.tree_util.tree_leaves` order: an
    ``nn.Module``'s parameters in registration order, a dict's values
    by sorted key, a list's or tuple's in order; None is no leaf."""
    if tree is None:
        return []
    if hasattr(tree, "named_parameters"):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]
'''),
        ('''\
        by_dtype.setdefault(str(getattr(a, "dtype", a)), []).append(i)''',
         '''\
        by_dtype.setdefault(dtype_name(getattr(a, "dtype", a)),
                            []).append(i)'''),
    ],
    "tracing.py": [
        ("merge, flight recorder, and straggler attribution.\n",
         "merge, flight recorder, and straggler attribution.\n\n"
         "Port copy (horovod_tpu_torch): byte-identical to the JAX "
         "package's\nmodule but for this paragraph and the "
         "profiler probe, which asks\ntorch's autograd "
         "profiler instead of XLA's TraceMe (pinned by\n"
         "tests/test_torch_port_isolation.py).\n"),
        ("        from jax._src.lib import xla_client\n"
         "        probe = xla_client._xla.profiler.TraceMe.is_enabled\n",
         "        import torch\n"
         "        probe = torch._C._autograd._profiler_enabled\n"),
        ("# noqa: BLE001 — unknown jax layout",
         "# noqa: BLE001 — unknown torch layout"),
    ],
}


def _read(*parts):
    with open(os.path.join(REPO, *parts), encoding="utf-8") as f:
        return f.read()


@pytest.mark.parametrize("module", sorted(DECLARED))
def test_copied_module_differs_only_as_declared(module):
    expect = _read("horovod_tpu", module)
    for old, new in DECLARED[module]:
        assert old in expect, f"declared text gone from the reference: " \
                              f"{old[:60]!r}"
        expect = expect.replace(old, new)
    assert _read("horovod_tpu_torch", module) == expect


def test_knob_registry_matches_reference():
    from horovod_tpu.common import config as jcfg
    from horovod_tpu_torch.common import config as tcfg

    def table(mod):
        return [(k.env, getattr(k.type, "__name__", repr(k.type)),
                 k.default) for k in mod.KNOBS]

    assert table(tcfg) == table(jcfg)
    for name in ("HOROVOD_FLASH_ATTENTION", "HOROVOD_SERVING_MAX_BATCH",
                 "HOROVOD_SERVING_LATENCY_BUDGET_MS"):
        env = {name: "4"}
        assert tcfg.env_value(name, env) == jcfg.env_value(name, env)


def _imported_roots(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _port_sources():
    for root, _, files in os.walk(PORT):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    sources = list(_port_sources())
    assert len(sources) > 10
    bad = [(os.path.relpath(p, REPO), root) for p in sources
           for root in _imported_roots(p) if root in FORBIDDEN]
    assert bad == []


def test_import_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, horovod_tpu_torch, horovod_tpu_torch.serving\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def _port_modules():
    for path in _port_sources():
        rel = os.path.relpath(path, REPO)
        if rel.startswith("horovod_tpu_torch"):
            yield rel[:-3].replace(os.sep, ".").replace(".__init__", "")


def test_every_module_of_the_port_imports_without_jax():
    modules = sorted(_port_modules())
    for name in ("horovod_tpu_torch.common.basics",
                 "horovod_tpu_torch.core.native",
                 "horovod_tpu_torch.ops.controller",
                 "horovod_tpu_torch.ops.engine",
                 "horovod_tpu_torch.ops.order_check",
                 "horovod_tpu_torch.common.topology",
                 "horovod_tpu_torch.ops.adasum",
                 "horovod_tpu_torch.ops.adasum_kernels",
                 "horovod_tpu_torch.ops.collective_ops",
                 "horovod_tpu_torch.ops.compression",
                 "horovod_tpu_torch.ops.process_set",
                 "horovod_tpu_torch.ops._cuda_build",
                 "horovod_tpu_torch.optim.functions",
                 "horovod_tpu_torch.optim.distributed_optimizer",
                 "horovod_tpu_torch.numerics",
                 "horovod_tpu_torch.ops.bucketing",
                 "horovod_tpu_torch.parallel.mesh"):
        assert name in modules, name
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_running_the_collectives_loads_no_jax():
    """A world of one runs every collective of the port, the vhdd
    schedule on a wire of its own and a registered set, and has loaded
    neither jax nor horovod_tpu."""
    code = (
        "import sys, torch\n"
        "import horovod_tpu_torch as hvd\n"
        "from horovod_tpu_torch.ops import adasum\n"
        "hvd.init(process_sets=[hvd.ProcessSet([0])])\n"
        "x = torch.arange(6.0).reshape(3, 2)\n"
        "for op in (hvd.Sum, hvd.Average, hvd.Min, hvd.Max, hvd.Product,\n"
        "           hvd.Adasum):\n"
        "    hvd.allreduce(x, op=op)\n"
        "hvd.allgather(x); hvd.grouped_allgather([x, x])\n"
        "hvd.alltoall(x, splits=[3]); hvd.reducescatter(x)\n"
        "hvd.grouped_reducescatter([x]); hvd.allgather_object(1)\n"
        "hvd.barrier(); hvd.broadcast_object(1)\n"
        "class Echo:\n"
        "    def swap(self, send, partner): return send.clone()\n"
        "    def partials(self, p): return torch.stack([p, p])\n"
        "    def merge(self, seg, ra, rb): return seg, seg\n"
        "adasum.vhdd(torch.ones(4), 0, 2, Echo())\n"
        "hvd.shutdown()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_the_negotiated_engine_loads_no_jax():
    """A world of one on the C++ core (HOROVOD_CONTROLLER=native) runs
    every kind of negotiated batch and join, and has loaded neither jax
    nor horovod_tpu."""
    code = (
        "import sys, torch\n"
        "import horovod_tpu_torch as hvd\n"
        "hvd.init(config_overrides={'HOROVOD_CONTROLLER': 'native',\n"
        "                           'HOROVOD_ORDER_CHECK': True})\n"
        "x = torch.arange(6.0).reshape(3, 2)\n"
        "hvd.grouped_allreduce([x, x.double()]); hvd.allgather(x)\n"
        "hvd.broadcast(x, 0); hvd.reducescatter(x); hvd.alltoall(x)\n"
        "hvd.barrier(); hvd.check_execution_order(); hvd.join()\n"
        "hvd.shutdown()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


# The C++ control core: the library's sources and Makefile are the
# reference's bytes (its stress, fuzz and tree-unit harnesses stay in
# the reference).
CORE_SOURCES = ["Makefile", "c_api.cc", "common.h", "controller.cc",
                "controller.h", "sha256.h", "thread_annotations.h",
                "tree.h", "wire.h"]


@pytest.mark.parametrize("name", CORE_SOURCES)
def test_core_source_is_the_references(name):
    with open(os.path.join(REPO, "horovod_tpu", "core", "cc", name),
              "rb") as f:
        want = f.read()
    with open(os.path.join(PORT, "core", "cc", name), "rb") as f:
        assert f.read() == want


def test_core_holds_only_the_library_sources():
    assert sorted(os.listdir(os.path.join(PORT, "core", "cc"))) == \
        sorted(CORE_SOURCES)


# function and class copies: (port module, reference module, name; a
# method as Class.method) -> the declared replacements that turn the
# reference's source into the port's. OWN_DOCSTRING: the port's copy
# has a docstring of its own (both docstrings are left out).
OWN_DOCSTRING = "own docstring"
DECLARED_FUNCTIONS = {
    ("core/native.py", "core/native.py", "BatchEntry"): [],
    ("core/native.py", "core/native.py", "NativeCore"): [
        ("""        lib = load()
        if lib is None:
            raise RuntimeError("native core not built")
""", """        lib = load()
"""),
        ("stable-composition (= stably-compiled) batch.",
         "stable-composition batch.")],
    ("ops/controller.py", "ops/controller.py", "PythonCore"): [],
    ("ops/controller.py", "ops/controller.py", "parse_allreduce_sig"): [],
    ("ops/controller.py", "ops/controller.py", "allreduce_sig"): [
        OWN_DOCSTRING,
        ('f"{jnp.dtype(rd)}:"', 'f"{dtype_name(rd)}:"'),
        ('f"ar|{jnp.dtype(wire_dtype)}|', 'f"ar|{dtype_name(wire_dtype)}|'),
    ],
    ("ops/engine.py", "ops/engine.py", "Engine.auto_name"): [],
    ("ops/engine.py", "ops/engine.py", "Engine.new_handle"): [],
    ("ops/engine.py", "ops/engine.py", "Engine.get_handle"): [],
    ("ops/engine.py", "ops/engine.py", "Engine.add_release_hook"): [],
    ("ops/engine.py", "ops/engine.py", "Engine.release_handle"): [],
    ("ops/adasum.py", "ops/adasum.py", "_pow2_blocks"): [],
    ("ops/adasum.py", "ops/adasum.py", "adasum_reference"): [
        ('"""Pure-numpy model of the tree fold, for tests."""',
         '"""Pure-numpy model of the tree fold, for tests (a copy of the\n'
         '    reference\'s, l.466)."""')],
}


def _function_source(path, name, drop_docstring=False):
    text = _read(*path.split("/"))
    body = ast.parse(text).body
    *outer, leaf = name.split(".")
    for cls in outer:
        body = next(n.body for n in body
                    if isinstance(n, ast.ClassDef) and n.name == cls)
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                and node.name == leaf:
            src = ast.get_source_segment(text, node)
            if drop_docstring and ast.get_docstring(node) is not None:
                src = src.replace(
                    ast.get_source_segment(text, node.body[0]), "", 1)
            return src
    raise AssertionError(f"{name} not in {path}")


@pytest.mark.parametrize("key", sorted(DECLARED_FUNCTIONS))
def test_copied_function_differs_only_as_declared(key):
    port, ref, name = key
    declared = DECLARED_FUNCTIONS[key]
    own_doc = OWN_DOCSTRING in declared
    expect = _function_source(f"horovod_tpu/{ref}", name, own_doc)
    for old, new in (d for d in declared if d != OWN_DOCSTRING):
        assert old in expect
        expect = expect.replace(old, new)
    assert _function_source(f"horovod_tpu_torch/{port}", name,
                            own_doc) == expect


# The port's K1/K2 sources cite the reference's functions by line: a name
# in backquotes followed by "(l.N" (horovod_tpu/ops/pallas_kernels.py,
# the file both sources name as their counterpart) or by
# "(ops/<module>.py:N" (that module of horovod_tpu).
_CITATION = re.compile(r"`{1,2}(\w+)`{1,2} \((?:l\.|(ops/\w+\.py):)(\d+)")


@pytest.mark.parametrize("source", ["horovod_tpu_torch/ops/adasum_kernels.py",
                                    "horovod_tpu_torch/csrc/"
                                    "adasum_pair_combine.cu"])
def test_k1_k2_sources_cite_the_reference_lines_of_its_functions(source):
    cited = _CITATION.findall(_read(*source.split("/")))
    assert len(cited) >= 4, cited
    wrong = []
    for name, module, line in cited:
        ref = f"horovod_tpu/{module or 'ops/pallas_kernels.py'}"
        text = _read(*ref.split("/")).splitlines()[int(line) - 1]
        if not re.match(rf"\s*def {name}\(", text):
            wrong.append(f"{name} cited at {ref}:{line}, which reads "
                         f"{text.strip()!r}")
    assert wrong == []
