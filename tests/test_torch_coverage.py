"""The port's completeness against the JAX package, read from the sources
with ``ast`` (nothing is imported, no card).

Every JAX module has a port module at the same path under
``sgs_gnn_tpu_torch/`` (or at a named rename), every public top-level name
of a JAX module has a counterpart in the port, and every ``pl.pallas_call``
site of the JAX package maps to a port wrapper that launches a CUDA source
of ``sgs_gnn_tpu_torch/csrc/``. The exceptions are the allow-lists below,
one reason per entry; an entry that no longer matches the sources fails,
so the lists stay exact."""
import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX = ROOT / "sgs_gnn_tpu"
PORT = ROOT / "sgs_gnn_tpu_torch"
SUBPACKAGES = ["baselines", "core", "data", "eval", "models", "ops",
               "parallel", "run", "sparsify", "train", "utils", "viz"]

# JAX module -> the port module that holds its counterparts
MODULE_RENAMES = {"ops/scatter_pallas.py": "ops/scatter.py",
                  "ops/spmm_pallas.py": "ops/spmm.py"}
# JAX modules without a port module
NO_MODULE = {
    "core/fastpath.py": "the process-wide Pallas switch for GSPMD "
                        "shardings; a sharded head in the port picks the "
                        "unfused route itself",
    "utils/compcache.py": "JAX's compilation cache; the port's is the "
                          "kernel build cache of ops/_build.py",
}
# "JAX module:name" -> "port module:name" where the counterpart has another
# name or lives in another module
RENAMED = {
    "core/graph.py:edge_homophily": "data/transforms.py:edge_homophily",
    "data/vendored.py:has_vendored": "core/config.py:has_vendored",
    "parallel/tensor_parallel.py:make_dp_tp_mesh":
        "parallel/mesh.py:make_dp_tp_mesh",
    "ops/scatter_pallas.py:scatter_add_pallas": "ops/scatter.py:scatter_add",
    "ops/scatter_pallas.py:scatter_add_sorted_pallas":
        "ops/scatter.py:scatter_add_sorted",
    "ops/spmm_pallas.py:spmm_pallas": "ops/spmm.py:spmm",   # "fused"
    "ops/spmm.py:spmm_xla": "ops/spmm.py:spmm",             # "auto"
    # the JAX references and fallbacks: the port's plain versions
    "ops/score_sampled.py:score_head_sampled_reference":
        "ops/score_sampled.py:score_head_plain",
    "ops/score_tiles.py:score_head_tiles_reference":
        "ops/score_tiles.py:score_head_tiles_plain",
    "ops/score_tiles.py:score_head_tiles_fallback":
        "ops/score_tiles.py:score_head_tiles_plain",
}
# "JAX module:name" -> why the port has no counterpart
NO_COUNTERPART = {
    # VMEM gates: a TPU kernel's working set in scoped VMEM; the port's
    # plans size shared memory instead (scatter_plan, segment_plan,
    # spmm_plan)
    "ops/scatter_pallas.py:scatter_block_for": "TPU VMEM gate",
    "ops/scatter_pallas.py:scatter_vmem_bytes": "TPU VMEM gate",
    "ops/scatter_pallas.py:sorted_scatter_block_for": "TPU VMEM gate",
    "ops/scatter_pallas.py:sorted_scatter_vmem_bytes": "TPU VMEM gate",
    "ops/spmm_pallas.py:fits_vmem": "TPU VMEM gate",
    "ops/score_sampled.py:fused_head_block": "TPU VMEM gate",
    "ops/score_sampled.py:use_fused_sampled_head":
        "boolean form of the fused_head_block VMEM gate",
    "ops/score_sampled.py:DEFAULT_HEAD_BAND":
        "the banded one-hot's width; a Hopper gather reads rows directly",
    # GSPMD and shard_map plumbing: each rank holds only its own data
    "parallel/distributed.py:make_global_mesh":
        "global device mesh; a rank joins a process group instead",
    "parallel/distributed.py:stack_local_to_global":
        "global array from per-host shards; each rank keeps its own",
    "parallel/partitioned.py:shard_batches":
        "device_put onto a mesh; each rank keeps its own partitions",
    "parallel/partitioned.py:stack_batches":
        "stacks partitions for shard_map; each rank keeps its own",
    "parallel/halo_train.py:make_exchange":
        "builds the shard_map ppermute rounds; the port's Exchange is one "
        "all_to_all_single",
    "parallel/halo_train.py:shard_halo_batch":
        "device_put of the halo tables onto a mesh; each rank builds its "
        "own HaloBatch",
    # functional optimizer and flax state: torch modules and optimizers
    # hold their own
    "train/optim.py:DualOptState": "optax state tuple; DualOptimizer "
                                   "holds its state",
    "train/optim.py:init_dual_opt": "optax init; DualOptimizer's "
                                    "constructor",
    "train/optim.py:make_mask": "optax parameter mask; DualOptimizer "
                                "takes the parameter groups",
    "models/backbones.py:init_params": "flax init; a torch module holds "
                                       "its parameters when built",
    # Orbax
    "run/checkpoint.py:save_checkpoint_orbax":
        "Orbax checkpoint; the port saves with torch.save",
}
# each pl.pallas_call site, keyed by (JAX module, enclosing functions):
# the port module and wrapper that launches its kernel through
# ops/_build.call, and the CUDA source compiled for it
PALLAS_SITES = {
    ("ops/scatter_pallas.py", "scatter_add_sorted_pallas"):
        ("ops/scatter.py", "scatter_add_sorted", "csrc/scatter_sorted.cu"),
    ("ops/scatter_pallas.py", "scatter_add_pallas"):
        ("ops/scatter.py", "_scatter_add", "csrc/scatter.cu"),
    ("ops/scatter_pallas.py", "_segment_sum_scalar_pallas"):
        ("ops/scatter.py", "_segment_sum_scalar", "csrc/segment_sum.cu"),
    ("ops/score_sampled.py", "_fwd_call.call_full"):
        ("ops/score_sampled.py", "_head_fwd", "csrc/score_sampled.cu"),
    ("ops/score_sampled.py", "_fwd_call.call_banded"):
        ("ops/score_sampled.py", "_head_fwd", "csrc/score_sampled.cu"),
    ("ops/score_sampled.py", "_bwd_call.call_full"):
        ("ops/score_sampled.py", "_head_bwd", "csrc/score_sampled.cu"),
    ("ops/score_sampled.py", "_bwd_call.call_banded"):
        ("ops/score_sampled.py", "_head_bwd", "csrc/score_sampled.cu"),
    ("ops/score_tiles.py", "_score_tiles_call"):
        ("ops/score_tiles.py", "score_head_tiles", "csrc/score_tiles.cu"),
    ("ops/spmm_pallas.py", "_spmm_pallas_impl"):
        ("ops/spmm.py", "_spmm_fused", "csrc/spmm.cu"),
}


def _tree(path):
    return ast.parse(path.read_text(), filename=str(path))


def _top_names(path):
    """The functions, classes and names that ``path`` defines or assigns
    at its top level."""
    names = set()
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
    return names


def _public_names(path):
    return {n for n in _top_names(path) if not n.startswith("_")}


def _defined(path, name):
    return name in _top_names(path)


def _jax_modules(sub):
    return sorted(p.relative_to(JAX).as_posix()
                  for p in (JAX / sub).rglob("*.py"))


def _port_module(rel):
    return PORT / MODULE_RENAMES.get(rel, rel)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_module_and_name_has_a_port_counterpart(sub):
    mods = _jax_modules(sub)
    assert mods, f"no JAX module under {sub}/"
    missing = []
    for rel in mods:
        port = _port_module(rel)
        if rel in NO_MODULE:
            assert not port.exists(), f"{rel} is ported now: drop it from " \
                                      "NO_MODULE"
            continue
        if not port.exists():
            missing.append(f"module {rel}")
            continue
        for name in sorted(_public_names(JAX / rel)):
            key = f"{rel}:{name}"
            if key in NO_COUNTERPART:
                assert not _defined(port, name), \
                    f"{key} has a counterpart now: drop it from " \
                    "NO_COUNTERPART"
            elif key in RENAMED:
                mod, new = RENAMED[key].split(":")
                if not _defined(PORT / mod, new):
                    missing.append(f"{key} (as {RENAMED[key]})")
            elif not _defined(port, name):
                missing.append(key)
    assert not missing, f"no counterpart in the port: {missing}"


def test_lists_match_the_jax_package():
    """SUBPACKAGES are the JAX package's, and every allow-list entry names
    a module or public name of the JAX package, with a reason."""
    assert sorted(SUBPACKAGES) == sorted(
        p.parent.name for p in JAX.glob("*/__init__.py"))
    for rel, why in NO_MODULE.items():
        assert (JAX / rel).exists() and why
    for key in list(RENAMED) + list(NO_COUNTERPART):
        rel, name = key.split(":")
        assert name in _public_names(JAX / rel), key
    assert all(NO_COUNTERPART.values())
    assert not set(RENAMED) & set(NO_COUNTERPART)


def _pallas_sites():
    """{(JAX module, dotted enclosing functions): number of
    ``pl.pallas_call`` calls} over the whole JAX package."""
    sites = {}

    def walk(node, scope, rel):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                walk(child, scope + [child.name], rel)
                continue
            if isinstance(child, ast.Call) and \
                    isinstance(child.func, ast.Attribute) and \
                    child.func.attr == "pallas_call":
                key = (rel, ".".join(scope))
                sites[key] = sites.get(key, 0) + 1
            walk(child, scope, rel)

    for path in sorted(JAX.rglob("*.py")):
        walk(_tree(path), [], path.relative_to(JAX).as_posix())
    return sites


def _build_sources():
    """ops/_build.py's SOURCES tuple: the CUDA files compiled."""
    for node in _tree(PORT / "ops" / "_build.py").body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "SOURCES"
                for t in node.targets):
            return set(ast.literal_eval(node.value))
    raise AssertionError("ops/_build.py defines no SOURCES")


def test_every_pallas_call_site_has_a_cuda_wrapper():
    sites = _pallas_sites()
    assert sites == dict.fromkeys(PALLAS_SITES, 1)
    assert len(PALLAS_SITES) == 9
    sources = _build_sources()
    for (rel, scope), (mod, wrapper, src) in PALLAS_SITES.items():
        path = PORT / mod
        fn = next((n for n in _tree(path).body
                   if isinstance(n, ast.FunctionDef) and n.name == wrapper),
                  None)
        assert fn is not None, f"{rel} {scope}: no {mod}:{wrapper}"
        # the wrapper launches its kernel through ops/_build.call
        assert re.search(r"\b_build\.call\(", ast.unparse(fn)), \
            f"{mod}:{wrapper} launches no kernel"
        assert (PORT / src).is_file() and Path(src).name in sources, \
            f"{rel} {scope}: {src} is not a built CUDA source"
