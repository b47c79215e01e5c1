"""taxtk_torch does all that taxtk does: a check of the two packages'
sources, by `ast`, importing neither.

For every module of taxtk/ with a namesake in taxtk_torch/ (or a
counterpart named in MODULES), each top-level function, class, method and
UPPER_CASE constant of the taxtk module must be defined or imported in the
port module, and each argument of an `__init__` or of a public function or
method must be one of its counterpart's.  What the port leaves out on
purpose stands in NAMES, ARGS and MODULES, each with its reason (ROADMAP's
"Left out on purpose" and "Not to port"); an entry whose name the port has
after all fails as stale.  Every `pl.pallas_call` site of taxtk/ops
belongs to a kernel whose CUDA source chip_smoke.py builds and holds
against its plain version (KERNEL_SOURCES).
"""

import ast
import pathlib
import re

ROOT = pathlib.Path(__file__).resolve().parent.parent
TAXTK = ROOT / "taxtk"
PORT = ROOT / "taxtk_torch"
UPPER = re.compile(r"^[A-Z][A-Z0-9_]*$")

# taxtk module -> the port module that holds its names, or None with the
# reason it has none
MODULES = {
    "ops/protein_align.py": ("ops/protein_ref.py",
                             "the plain recurrence of the protein kernels"),
    "ops/myers_batch.py": (None, "taxtk's XLA Myers (the myers backend): not "
                           "to port; its peq build and recurrence have "
                           "copies in ops/myers_ref.py"),
    "ops/oracle.py": (None, "taxtk's fallback when its host C++ fails to "
                      "load: not to port, the port has no fallback"),
    "ops/pallas_myers.py": (None, "csrc/myers_short.cu and "
                            "csrc/myers_chunked.cu"),
    "ops/pallas_myers_systolic.py": (None, "csrc/myers_systolic.cu"),
    "ops/pallas_protein.py": (None, "csrc/protein_wavefront.cu and "
                              "csrc/protein_swar.cu"),
    "ops/pallas_dna.py": (None, "csrc/dna_wavefront.cu"),
}

# (taxtk module, name) -> (the port's counterpart in the same module or
# None, reason)
NAMES = {
    ("engine/aligner.py", "BatchAligner._dispatch_tpu_long"): (
        "BatchAligner._dispatch_long", "the long route, renamed"),
    ("engine/aligner.py", "BatchAligner._myers_sharded"): (
        "BatchAligner._dispatch_mesh", "a bare mesh spreads its pairs "
        "over the grid's cells as an engine mesh does"),
    ("engine/aligner.py", "BatchAligner._tick"): (
        "BatchAligner._stage", "the stage stopwatch, now a span of "
        "engine/metrics.py's recorder summed into stage_seconds"),
    ("engine/aligner.py", "BatchAligner._warn_fallback"): (
        None, "warns of a Pallas fallback; the port has no fallback"),
    ("engine/aligner.py", "_default_dna_backend"): (
        None, "the port picks defaults from its device in __init__"),
    ("engine/aligner.py", "_default_protein_backend"): (
        None, "the port picks defaults from its device in __init__"),
    ("engine/aligner.py", "_on_accelerator"): (
        None, "asks JAX for a TPU; the port is given its device"),
    ("ops/dna_align.py", "_edit_distance_kernel"): (
        "edit_distance_wavefront", "the XLA scan's torch version"),
    ("ops/protein_align.py", "_protein_kernel"): (
        "nw_stats", "the XLA scan's torch version"),
    ("ops/seqpool.py", "_pool_append"): (
        "DevicePoolCache.ensure", "a donated XLA update; torch copies in "
        "place"),
    ("ops/seqpool.py", "_pool_grow"): (
        "DevicePoolCache.ensure", "a donated XLA concat; torch grows the "
        "pool by doubling"),
    ("ops/seqpool.py", "_pow2_floor"): (
        None, "sized taxtk's budget-fixed capacity (a TPU recompile per "
        "width); the port's capacity starts small and doubles"),
    ("parallel/engine_mesh.py", "MeshEngineBackend._merge_step"): (
        "_merge", "the shard_map merge; single controller, one function"),
    ("parallel/engine_mesh.py", "MeshEngineBackend._paths"): (
        None, "a replicated device array; parallel/mesh.py::_Paths keeps "
        "one copy per device"),
    ("parallel/engine_mesh.py", "MeshEngineBackend._put"): (
        None, "jax.device_put with a sharding; single controller, each "
        "cell's tensor is moved with .to(device)"),
}

# (taxtk module, function, argument) -> reason
ARGS = {
    ("engine/aligner.py", "BatchAligner.__init__", "pallas_interpret"):
        "a TPU knob: Pallas interpret mode",
}

# taxtk/ops function holding a pl.pallas_call -> the kernel that ports it
PALLAS_SITES = {
    ("pallas_myers.py", "_pallas_single"): "myers_short",
    ("pallas_myers.py", "_call_interpret"): "myers_short",
    ("pallas_myers.py", "_pallas_chunked"): "myers_chunked",
    ("pallas_myers_systolic.py", "_call_systolic"): "myers_systolic",
    ("pallas_protein.py", "_raw_call"): "protein_wavefront",
    ("pallas_protein.py", "_raw_call_swar"): "protein_swar",
    ("pallas_dna.py", "_pallas_call"): "dna_wavefront",
}


def _top(body):
    """Top-level statements, those inside if/try blocks included."""
    for node in body:
        if isinstance(node, (ast.If, ast.Try)):
            yield from _top(node.body)
            yield from _top(node.orelse)
            for h in getattr(node, "handlers", []):
                yield from _top(h.body)
            yield from _top(getattr(node, "finalbody", []))
        else:
            yield node


def _surface(path):
    """(names the module defines, names it imports or assigns, function
    and method -> argument names)."""
    defined, other, args = set(), set(), {}
    for node in _top(ast.parse(path.read_text()).body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defined.add(node.name)
            args[node.name] = node.args
        elif isinstance(node, ast.ClassDef):
            defined.add(node.name)
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    defined.add(f"{node.name}.{m.name}")
                    args[f"{node.name}.{m.name}"] = m.args
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                for e in ast.walk(t):
                    if isinstance(e, ast.Name):
                        (defined if UPPER.match(e.id) else other).add(e.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                other.add((a.asname or a.name).split(".")[0])
    names = {n: [a.arg for a in v.posonlyargs + v.args + v.kwonlyargs]
             + [a.arg for a in (v.vararg, v.kwarg) if a]
             for n, v in args.items()}
    return defined, other, names


def _public(name):
    return all(not p.startswith("_") or p == "__init__"
               for p in name.split("."))


def _pairs():
    """(taxtk module, port module) of every taxtk module with a
    counterpart."""
    for path in sorted(TAXTK.rglob("*.py")):
        rel = path.relative_to(TAXTK).as_posix()
        target = MODULES.get(rel, (rel, ""))[0]
        if target is not None:
            yield rel, target


def test_every_taxtk_module_has_a_counterpart():
    missing = [rel for rel, port in _pairs() if not (PORT / port).exists()]
    assert missing == []
    for rel, (port, reason) in MODULES.items():
        assert (TAXTK / rel).exists() and reason, rel
        assert port is not None or not (PORT / rel).exists(), (
            f"{rel} is listed as not ported, but taxtk_torch/{rel} exists")
        for cu in re.findall(r"csrc/(\w+)\.cu", reason):
            assert (PORT / "csrc" / f"{cu}.cu").exists(), cu


def test_every_public_name_has_a_counterpart():
    gaps, bad_args, stale = [], [], []
    seen_names, seen_args = set(), set()
    for rel, port in _pairs():
        names, _, args = _surface(TAXTK / rel)
        pdef, pother, pargs = _surface(PORT / port)
        have = pdef | pother
        for name in sorted(names):
            key = (rel, name)
            if key in NAMES:
                seen_names.add(key)
                counterpart = NAMES[key][0]
                if name in have or (counterpart is not None
                                    and counterpart not in pdef):
                    stale.append(key)
            elif name not in have:
                gaps.append(key)
        for name, want in sorted(args.items()):
            if name not in pargs or not _public(name):
                continue
            for arg in want:
                key = (rel, name, arg)
                if key in ARGS:
                    seen_args.add(key)
                    if arg in pargs[name]:
                        stale.append(key)
                elif arg not in pargs[name]:
                    bad_args.append(key)
    assert gaps == [], "taxtk names with no counterpart in taxtk_torch"
    assert bad_args == [], "taxtk arguments the port does not take"
    assert stale == [], "exceptions that no longer hold"
    assert seen_names == set(NAMES) and seen_args == set(ARGS)
    assert all(reason for _, reason in NAMES.values())
    assert all(ARGS.values())


def test_the_walk_sees_what_it_should(tmp_path):
    """The surface walk itself: functions, methods, UPPER_CASE constants,
    names inside if/try, imports, and argument lists."""
    src = tmp_path / "m.py"
    src.write_text(
        "import numpy as np\n"
        "from x import y as z\n"
        "LIMIT = 3\n"
        "lower = 4\n"
        "try:\n    def f(a, *b, c=1, **d):\n        pass\n"
        "except ImportError:\n    pass\n"
        "class C:\n    def __init__(self, mesh=None):\n        pass\n"
        "    def _g(self):\n        pass\n")
    defined, other, args = _surface(src)
    assert defined == {"LIMIT", "f", "C", "C.__init__", "C._g"}
    assert {"np", "z", "lower"} <= other
    assert args["f"] == ["a", "c", "b", "d"]
    assert args["C.__init__"] == ["self", "mesh"]
    assert _public("C.__init__") and not _public("C._g")
    assert not _public("_DevPending.__init__")


def _kernel_sources():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and [t.id for t in node.targets] == ["KERNEL_SOURCES"]):
            return ast.literal_eval(node.value)
    raise AssertionError("chip_smoke.py has no KERNEL_SOURCES")


def test_every_pallas_call_maps_to_a_built_kernel():
    sites = set()
    for path in sorted((TAXTK / "ops").glob("*.py")):
        for fn in ast.parse(path.read_text()).body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            for node in ast.walk(fn):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "pallas_call"):
                    sites.add((path.name, fn.name))
    assert len(sites) == 7
    assert sites == set(PALLAS_SITES)
    built = _kernel_sources()
    assert sorted(built) == sorted(set(PALLAS_SITES.values()))
    for name in built:
        assert (PORT / "csrc" / f"{name}.cu").exists(), name
