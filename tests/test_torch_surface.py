"""The port's whole public surface against `slam_tpu`'s.

Every module of `slam_tpu/` is read with `ast` (nothing of it is
imported), and so is its counterpart in `slam_tpu_torch/`: each public
top-level function, class and assigned name, each public class member
(method, property, dataclass field, attribute set in `__init__`) and each
parameter name of those functions and methods has its counterpart in the
port, but for the entries of `EXCEPTIONS`, each with its reason. A second
case holds every entry of the table to something that `slam_tpu/` still
has; a third imports the port alone and resolves every name that the JAX
package's `__init__.py` files bind.
"""

from __future__ import annotations

import ast
import functools
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_ROOT = REPO / "slam_tpu"
PORT_ROOT = REPO / "slam_tpu_torch"

GENERATOR = ("threefry keys become torch.Generator objects (Philox); the JAX and "
             "torch streams differ, ROADMAP watch list")

# (JAX file under slam_tpu/, qualified name or None for the module, parameter
# or None) -> (the port's counterpart or None, why). A counterpart names a
# port file for a module, a top-level name or "Class.member" of the port's
# module for a name, a parameter of the port's function for a parameter.
EXCEPTIONS = {
    # Modules.
    ("ops/motion_pallas.py", None, None): (
        "ops/motion_cuda.py", "the Pallas kernel K1 is the CUDA kernel "
        "csrc/motion_odometry.cu; its wrapper module"),
    ("ops/pano_pallas.py", None, None): (
        "ops/pano_cuda.py", "the Pallas kernel K2 is the CUDA kernel "
        "csrc/gather_rows.cu; its wrapper module"),
    # The Pallas entry points' names and tiling parameters.
    ("ops/motion_pallas.py", "sample_motion_model_odometry_pallas", None): (
        "sample_motion_model_odometry_fused", "the CUDA sampler draws its seed from "
        "`generator` on the device (`launch(seed, odom, pose, alphas)` takes one raw)"),
    ("ops/pano_pallas.py", "gather_rows", "block"): (
        None, "the Pallas grid's rows a step; the CUDA kernel's block is fixed"),
    ("ops/pano_pallas.py", "gather_rows", "slots"): (
        None, "the Pallas DMA semaphores in flight; the CUDA kernel hides latency "
        "with warps"),
    ("ops/pano_pallas.py", "gather_rows", "interpret"): (
        None, "Pallas interpret mode; a CPU tensor takes the plain version rows[idx]"),
    # Random keys.
    ("apps/grid_slam.py", "auto_commands", "key"): ("generator", GENERATOR),
    ("core/stats.py", "sample_normal", "key"): ("generator", GENERATOR),
    ("core/stats.py", "sample_triangular", "key"): ("generator", GENERATOR),
    ("core/stats.py", "random_cell", "key"): ("generator", GENERATOR),
    ("models/fake_lidar.py", "scan", "key"): ("generator", GENERATOR),
    ("models/mcl.py", "init", "key"): ("generator", GENERATOR),
    ("models/mcl.py", "init_uniform", "key"): ("generator", GENERATOR),
    ("models/rbpf.py", "init", "key"): ("generator", GENERATOR),
    ("models/slam.py", "init", "key"): ("generator", GENERATOR),
    ("ops/motion.py", "sample_motion_model_odometry", "key"): ("generator", GENERATOR),
    ("ops/motion.py", "sample_motion_model_velocity", "key"): ("generator", GENERATOR),
    ("ops/resample.py", "multinomial_indices", "key"): ("generator", GENERATOR),
    ("ops/resample.py", "systematic_indices", "key"): ("generator", GENERATOR),
    ("ops/resample.py", "resample", "key"): ("generator", GENERATOR),
    ("ops/resample.py", "inject_random_particles", "key"): ("generator", GENERATOR),
    ("parallel/resample.py", "systematic_resample_sharded", "key"): ("generator", GENERATOR),
    ("models/fleet.py", "init_fleet", "key"): (
        "seed", "an int seed: fleet_seeds derives one Philox generator a robot"),
    ("utils/diagnostics.py", "recover", "key"): (
        "draws", "draws from the state's generator, or the injected draws"),
    ("models/mcl.py", "MCLState.key", None): ("MCLState.generator", GENERATOR),
    ("models/rbpf.py", "RBPFState.key", None): ("RBPFState.generator", GENERATOR),
    ("planners/rrtstar.py", "RRTState.key", None): (
        "RRTStar.generator", "the planner holds one generator for its life, reseeded "
        "a query; " + GENERATOR),
    # JAX device layouts.
    ("parallel/fleet.py", "robot_sharding", None): (
        None, "a jax NamedSharding spec; a rank of the port holds its robots' rows"),
    ("parallel/mapshard.py", "grid_sharding", None): (
        None, "a jax NamedSharding spec; a rank of the port holds its map block"),
    ("parallel/mesh.py", "make_mesh", "devices"): (
        "n_devices", "takes jax.Device objects; the port's ranks are processes "
        "of torch.distributed, counted"),
    ("parallel/distributed.py", "initialize", "coordinator_address"): (
        "init_method", "torch.distributed's rendezvous address"),
    ("parallel/distributed.py", "initialize", "num_processes"): (
        "world_size", "torch.distributed's name"),
    ("parallel/distributed.py", "initialize", "process_id"): (
        "rank", "torch.distributed's name"),
    ("parallel/edt.py", "lf_log_weights_sharded", "particle_axis"): (
        None, "names shard_map's particle spec in JAX; a rank of the port holds its "
        "particle shard and no collective of this function runs over particles"),
}

PUBLIC_DUNDERS = ("__init__", "__call__")


def _public(name: str) -> bool:
    return not name.startswith("_") or name in PUBLIC_DUNDERS


def _params(fn) -> list[str]:
    a = fn.args
    names = [p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)]
    names += [f"*{v.arg}" for v in (a.vararg,) if v] + [f"**{v.arg}" for v in (a.kwarg,) if v]
    return [n for n in names if n not in ("self", "cls")]


def _targets(node) -> list[str]:
    if isinstance(node, ast.Name):
        return [node.id]
    if isinstance(node, (ast.Tuple, ast.List)):
        return [n for e in node.elts for n in _targets(e)]
    return []  # attributes and subscripts bind no name


def _flat(body):
    """A body's statements, those under a top-level `if` / `try` included."""
    for s in body:
        if isinstance(s, ast.If):
            yield from _flat(s.body)
            yield from _flat(s.orelse)
        elif isinstance(s, ast.Try):
            yield from _flat(s.body)
            for h in s.handlers:
                yield from _flat(h.body)
            yield from _flat(s.orelse)
            yield from _flat(s.finalbody)
        else:
            yield s


def _class_members(cls: ast.ClassDef) -> dict:
    """member -> the FunctionDef, or None for a field or an attribute."""
    out = {}
    for s in _flat(cls.body):
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[s.name] = s
            if s.name == "__init__":
                for n in ast.walk(s):
                    if isinstance(n, (ast.Assign, ast.AnnAssign)):
                        for t in (n.targets if isinstance(n, ast.Assign) else [n.target]):
                            if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                                    and t.value.id == "self"):
                                out.setdefault(t.attr, None)
        elif isinstance(s, ast.Assign):
            for t in s.targets:
                out.update(dict.fromkeys(_targets(t)))
        elif isinstance(s, ast.AnnAssign):
            out.update(dict.fromkeys(_targets(s.target)))
    return out


class Module:
    """A module's top-level bindings, read with `ast`."""

    def __init__(self, path: Path, package: str):
        self.path, self.package = path, package
        tree = ast.parse(path.read_text())
        # name -> ("def", FunctionDef) | ("class", ClassDef) | ("name", value)
        #         | ("import", (module, name))
        self.top = {}
        for s in _flat(tree.body):
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.top[s.name] = ("def", s)
            elif isinstance(s, ast.ClassDef):
                self.top[s.name] = ("class", s)
            elif isinstance(s, ast.Assign):
                for t in s.targets:
                    for n in _targets(t):
                        self.top[n] = ("name", s.value)
            elif isinstance(s, ast.AnnAssign):
                for n in _targets(s.target):
                    self.top[n] = ("name", s.value)
            elif isinstance(s, ast.ImportFrom):
                for al in s.names:
                    self.top[al.asname or al.name] = ("import", (s.module, al.name))
            elif isinstance(s, ast.Import):
                for al in s.names:
                    self.top[al.asname or al.name.split(".")[0]] = ("import", (al.name, None))


@functools.cache
def _module(path: Path, package: str) -> Module:
    return Module(path, package)


def _resolve(mod: Module, name: str, depth: int = 0):
    """(kind, node, module) of `name` in `mod`, following imports from the
    same package and plain aliases (`a = b`)."""
    kind, node = mod.top[name]
    if depth > 8:
        return kind, node, mod
    if kind == "import":
        src, orig = node
        if orig is not None and src and src.split(".")[0] == mod.package:
            base = REPO.joinpath(*src.split("."))
            path = base.with_suffix(".py") if base.with_suffix(".py").exists() else base / "__init__.py"
            if path.exists():
                other = _module(path, mod.package)
                if orig in other.top:
                    return _resolve(other, orig, depth + 1)
    if kind == "name" and isinstance(node, ast.Name) and node.id in mod.top:
        return _resolve(mod, node.id, depth + 1)
    return kind, node, mod


def _members(mod: Module, cls: ast.ClassDef) -> dict:
    """A port class's members with those of its bases that the package
    defines."""
    out = {}
    for b in cls.bases:
        if isinstance(b, ast.Name) and b.id in mod.top:
            kind, node, owner = _resolve(mod, b.id)
            if kind == "class":
                out.update(_members(owner, node))
    out.update(_class_members(cls))
    return out


def _port_rel(rel: str) -> str:
    entry = EXCEPTIONS.get((rel, None, None))
    return entry[0] if entry else rel


def _check_params(rel, qual, jfn, pfn, gaps):
    pparams = _params(pfn)
    for p in _params(jfn):
        exc = EXCEPTIONS.get((rel, qual, p))
        if exc is not None:
            if exc[0] is not None and exc[0] not in pparams:
                gaps.append(f"{qual}({p}=): counterpart {exc[0]!r} missing")
            continue
        if p not in pparams:
            gaps.append(f"{qual}: parameter {p!r} missing (port: {pparams})")


def surface_gaps(rel: str) -> list[str]:
    """What the port lacks of `slam_tpu/<rel>`'s public surface."""
    jmod = _module(JAX_ROOT / rel, "slam_tpu")
    ppath = PORT_ROOT / _port_rel(rel)
    if not ppath.exists():
        return [f"no port module {ppath.relative_to(REPO)}"]
    pmod = _module(ppath, "slam_tpu_torch")
    gaps = []
    for name, (kind, jnode) in jmod.top.items():
        if kind == "import" or not _public(name):
            continue
        exc = EXCEPTIONS.get((rel, name, None))
        if exc is not None:
            if exc[0] is not None and exc[0] not in pmod.top:
                gaps.append(f"{name}: counterpart {exc[0]!r} missing")
            continue
        if name not in pmod.top:
            gaps.append(f"{name}: missing")
            continue
        pkind, pnode, powner = _resolve(pmod, name)
        if kind == "def":
            if pkind != "def":
                gaps.append(f"{name}: a function in slam_tpu, a {pkind} in the port")
            else:
                _check_params(rel, name, jnode, pnode, gaps)
        elif kind == "class":
            if pkind != "class":
                gaps.append(f"{name}: a class in slam_tpu, a {pkind} in the port")
                continue
            pmem = _members(powner, pnode)
            for m, jm in _class_members(jnode).items():
                if not _public(m):
                    continue
                qual = f"{name}.{m}"
                exc = EXCEPTIONS.get((rel, qual, None))
                if exc is not None:
                    if exc[0] is not None:
                        cname, cmem = exc[0].split(".")
                        ck, cnode, cown = _resolve(pmod, cname) if cname in pmod.top else (None,) * 3
                        if ck != "class" or cmem not in _members(cown, cnode):
                            gaps.append(f"{qual}: counterpart {exc[0]!r} missing")
                    continue
                if m not in pmem:
                    gaps.append(f"{qual}: member missing")
                elif jm is not None and pmem[m] is not None:
                    _check_params(rel, qual, jm, pmem[m], gaps)
    return gaps


JAX_FILES = sorted(str(p.relative_to(JAX_ROOT)) for p in JAX_ROOT.rglob("*.py"))


@pytest.mark.parametrize("rel", JAX_FILES)
def test_port_has_the_module_surface(rel):
    """Each public name, member and parameter of `slam_tpu/<rel>` has its
    counterpart in the port (the table's entries theirs)."""
    gaps = surface_gaps(rel)
    assert not gaps, f"slam_tpu/{rel}: " + "; ".join(gaps)


def _jax_has(rel, name, param) -> bool:
    path = JAX_ROOT / rel
    if not path.exists():
        return False
    if name is None:
        return True
    mod = _module(path, "slam_tpu")
    head, _, member = name.partition(".")
    if head not in mod.top:
        return False
    kind, node = mod.top[head]
    if member:
        if kind != "class" or member not in _class_members(node):
            return False
        node = _class_members(node)[member]
    elif param is not None and kind != "def":
        return False
    return param is None or (node is not None and param in _params(node))


def test_exceptions_name_what_slam_tpu_has():
    """No entry of the table outlives what it excuses, and each says why."""
    stale = [k for k in EXCEPTIONS if not _jax_has(*k)]
    assert not stale, f"entries naming nothing in slam_tpu/: {stale}"
    assert all(reason.strip() for _, reason in EXCEPTIONS.values())


def _init_bindings():
    """(package path, name) of every name the JAX `__init__.py` files bind
    from the package or by assignment (dunders included; a module's own
    typing imports and private helpers are the per-module case's)."""
    out = []
    for init in sorted(JAX_ROOT.rglob("__init__.py")):
        pkg = ".".join(init.parent.relative_to(REPO).parts[1:])
        for name, (kind, node) in Module(init, "slam_tpu").top.items():
            if name.startswith("_") and not name.endswith("__"):
                continue
            if kind == "name" or (kind == "import" and (node[0] or "").startswith("slam_tpu")):
                out.append((pkg, name))
    return out


def test_package_exports_resolve():
    """After `import slam_tpu_torch` alone (JAX unimportable), every name
    the JAX package's `__init__.py` files bind resolves on the port's
    packages, and no kernel was built."""
    names = _init_bindings()
    assert ("", "Pose") in names and ("ops", "edt") in names and ("models", "slam") in names
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['slam_tpu'] = None\n"
        "import slam_tpu_torch\n"
        f"names = {names!r}\n"
        "missing = []\n"
        "for pkg, name in names:\n"
        "    obj = slam_tpu_torch\n"
        "    try:\n"
        "        for part in [p for p in pkg.split('.') if p] + [name]:\n"
        "            obj = getattr(obj, part)\n"
        "    except AttributeError:\n"
        "        missing.append((pkg, name))\n"
        "from slam_tpu_torch import Odometry, Pose, Velocity\n"
        "from slam_tpu_torch.core.types import Pose as P\n"
        "assert Pose is P\n"
        "b = sys.modules.get('slam_tpu_torch.ops._build')\n"
        "assert b is None or b.library.cache_info().currsize == 0\n"
        "print(missing)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout
