"""The port's dry run (``launch.dryrun``) against the JAX package's: its
specs (inputs, microbatches, optimizer, every family's cache on the
16 × 16 and 2 × 16 × 16 meshes), the per-device argument bytes the
reference's parameter specs imply, cells of every family and the DLRM
cell on fake worlds of 256 and 512 ranks, the command line with
``launch.report``, and the counters the roofline reads (collectives by
their result bytes, each loop trip; an op seen once, on local shards).

The cells run smoke configs at small shapes (``SMALL``) so the file
stays in the test budget; the specs are held at the full configs."""

import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCH_IDS, SHAPES as J_SHAPES, get_config as j_get_config
from repro.dist import sharding as jsh
from repro_torch.configs import SHAPES, ShapeConfig, get_config
from repro_torch.dist import sharding as sh
from repro_torch.launch import dryrun, report
from repro_torch.launch.mesh_comms import CollectiveCounter
from repro_torch.launch.roofline import StepCounter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _FakeMesh:
    """Axis names and sizes for the spec logic (``tests/test_torch_sharding.py``)."""

    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()))


MESHES = {"pod16x16": _FakeMesh({"data": 16, "model": 16}),
          "pod2x16x16": _FakeMesh({"pod": 2, "data": 16, "model": 16})}
RULES = {"pod16x16": (sh.LOGICAL_RULES_SINGLE_POD, jsh.LOGICAL_RULES_SINGLE_POD),
         "pod2x16x16": (sh.LOGICAL_RULES_MULTI_POD, jsh.LOGICAL_RULES_MULTI_POD)}
SEQ_CACHE = {"k": (2,), "v": (2,), "k_scale": (2,), "v_scale": (2,)}
# the cells' shapes: the smoke configs at a few tokens, batches every dp divides
SMALL = {"train_4k": ShapeConfig("train_4k", 16, 32, "train"),
         "prefill_32k": ShapeConfig("prefill_32k", 16, 32, "prefill"),
         "decode_32k": ShapeConfig("decode_32k", 64, 32, "decode")}
RECORD_KEYS = {"cell", "arch", "shape", "mesh", "chips", "params", "active_params", "kind",
               "memory_analysis", "roofline", "compile_seconds"}
MEMORY_KEYS = {"argument_size_gib", "output_size_gib", "temp_size_gib", "alias_size_gib",
               "per_device_total_gib"}


@pytest.fixture(scope="module")
def jdry():
    """``repro.launch.dryrun``, imported after JAX's backend is up (the
    module sets ``XLA_FLAGS`` for 512 host devices on import) and with
    ``XLA_FLAGS`` restored, so no later process inherits it."""
    import jax

    jax.devices()
    prev = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if prev is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = prev
    return mod


def _smoke_overrides(arch):
    cfg = get_config(arch, smoke=True)
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


# ------------------------------------------------------------- the specs --


def _aval(a):
    return tuple(a.shape), str(a.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_microbatches_and_optimizer_equal_the_reference(jdry, arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name in J_SHAPES:
        got = {k: _aval(v) for k, v in dryrun.input_specs(cfg, SHAPES[name]).items()}
        want = {k: _aval(v) for k, v in jdry.input_specs(jcfg, J_SHAPES[name]).items()}
        assert got == want, (arch, name)
        assert all(v.device.type == "meta"
                   for v in dryrun.input_specs(cfg, SHAPES[name]).values())
        for dp in (16, 32):
            assert dryrun.pick_microbatches(cfg, SHAPES[name], dp) == \
                jdry.pick_microbatches(jcfg, J_SHAPES[name], dp)
    assert type(dryrun.pick_optimizer(cfg)).__name__ == type(jdry.pick_optimizer(jcfg)).__name__


def _flat_specs(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_specs(v, path + (k,)))
        return out
    return {path: tuple(tree)}


def _j_flat_specs(tree):
    import jax

    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))[0]
    return {tuple(p.key for p in path): tuple(spec) for path, spec in leaves}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_the_reference_for_every_family(jdry, arch):
    """Every leaf of the decode cache at ``decode_32k`` (and the windowed
    ``long_500k`` cache where the arch has it), int8 and bf16, with and
    without the sequence-sharded override, on both production meshes."""
    import jax

    from repro.serve.kvcache import init_cache as j_init_cache
    from repro_torch.serve.kvcache import init_cache

    cfg, jcfg = get_config(arch), j_get_config(arch)
    shapes = ["decode_32k"] + (["long_500k"] if cfg.subquadratic else [])
    for name in shapes:
        shape = SHAPES[name]
        window = dryrun.DECODE_WINDOW.get(name, shape.seq_len)
        for quant in (False, True):
            cache = init_cache(cfg, shape.global_batch, shape.seq_len, window=window,
                               quant=quant, device="meta")
            javals = jax.eval_shape(lambda: j_init_cache(
                jcfg, shape.global_batch, shape.seq_len, window=window, quant=quant))
            for mesh_name, mesh in MESHES.items():
                rules, jrules = RULES[mesh_name]
                for prio in (None, SEQ_CACHE):
                    got = _flat_specs(dryrun.cache_specs(cache, rules, mesh,
                                                         priority_override=prio))
                    want = _j_flat_specs(jdry.cache_specs(javals, jrules, mesh,
                                                          priority_override=prio))
                    assert got == want, (arch, name, quant, mesh_name, prio)


# --------------------------------------------------------------- the cells --


@pytest.fixture
def small_shapes(monkeypatch):
    for name, shape in SMALL.items():
        monkeypatch.setitem(SHAPES, name, shape)


def _local_bytes(shape, dtype_bytes, spec, sizes):
    n = math.prod(shape) * dtype_bytes
    for part in spec:
        for axis in (part if isinstance(part, tuple) else (part,) if part else ()):
            n //= sizes[axis]
    return n


@pytest.mark.parametrize("arch", ["minicpm-2b", "llama-3.2-vision-11b"])
def test_argument_bytes_are_those_the_reference_specs_imply(small_shapes, tmp_path, arch):
    """A prefill cell's per-device argument bytes: each parameter's shard
    under the reference's ``param_specs_for`` and ``sanitize_spec``, and the
    batch's under the dp axes."""
    import jax

    from repro.models.transformer import init_lm as j_init_lm

    jcfg = dataclasses.replace(j_get_config(arch), **{
        k: v for k, v in _smoke_overrides(arch).items() if k != "moe"})
    mesh = MESHES["pod16x16"]
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    avals = jax.eval_shape(lambda r: j_init_lm(r, jcfg), jax.random.PRNGKey(0))
    specs = jsh.sanitize_specs_tree(
        jsh.param_specs_for(avals, jsh.LOGICAL_RULES_SINGLE_POD, moe=jcfg.moe is not None),
        avals, mesh)
    want = sum(_local_bytes(a.shape, a.dtype.itemsize, s, sizes) for a, s in zip(
        jax.tree.leaves(avals), jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))))
    shape = SMALL["prefill_32k"]
    b, s = shape.global_batch, shape.seq_len
    want += b * s * 4 // sizes["data"]
    if jcfg.family == "vlm":
        want += b * jcfg.num_image_tokens * jcfg.d_model * 4 // sizes["data"]
    rec = dryrun.run_cell(arch, "prefill_32k", multi_pod=False, results_dir=str(tmp_path),
                          variant={"cfg_overrides": _smoke_overrides(arch)})
    assert rec["memory_analysis"]["argument_size_gib"] * 2**30 == want


CELLS = [("minicpm-2b", "train_4k", False), ("minicpm-2b", "prefill_32k", False),
         ("minicpm-2b", "decode_32k", False), ("minicpm-2b", "train_4k", True),
         ("granite-moe-3b-a800m", "train_4k", False), ("xlstm-125m", "train_4k", False),
         ("zamba2-7b", "train_4k", False), ("llama-3.2-vision-11b", "prefill_32k", False)]


def _finite_roofline(r):
    return all(np.isfinite(r[k]) for k in ("hlo_flops", "hlo_bytes", "collective_bytes",
                                           "compute_s", "memory_s", "collective_s",
                                           "roofline_fraction"))


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS)
def test_run_cell_writes_the_reference_record(small_shapes, tmp_path, arch, shape, multi_pod):
    rec = dryrun.run_cell(arch, shape, multi_pod=multi_pod, results_dir=str(tmp_path),
                          variant={"cfg_overrides": _smoke_overrides(arch)})
    kind = SHAPES[shape].kind
    want = RECORD_KEYS | ({"microbatches", "optimizer"} if kind == "train" else set())
    assert set(rec) == want
    assert set(rec["memory_analysis"]) == MEMORY_KEYS
    assert rec["chips"] == (512 if multi_pod else 256)
    assert rec["mesh"] == ("pod2x16x16" if multi_pod else "pod16x16")
    r = rec["roofline"]
    assert _finite_roofline(r) and r["hlo_flops"] > 0 and r["collective_breakdown"]
    assert set(r["collective_breakdown"]) <= {"all-gather", "all-reduce", "reduce-scatter",
                                              "all-to-all"}
    assert r["analytic_flops"] > 0 and rec["memory_analysis"]["per_device_total_gib"] > 0
    # the cached record comes back unchanged; the report renders it
    assert dryrun.run_cell(arch, shape, multi_pod=multi_pod, results_dir=str(tmp_path),
                           variant={"cfg_overrides": _smoke_overrides(arch)}) == rec
    table = report.roofline_table(report.load_cells(str(tmp_path)), rec["mesh"])
    assert f"| {arch} | {shape} |" in table


@pytest.mark.parametrize("variant", [{}, {"name": "hotrep", "hot_fraction": 0.02},
                                     {"name": "smbag", "shardmap_bag": True}])
def test_dlrm_cell_and_its_variants(tmp_path, variant):
    """The sharded bag reduces output-sized partials where the plain
    gather fetches whole tables."""
    rec = dryrun.run_dlrm_cell(multi_pod=False, results_dir=str(tmp_path), variant=variant)
    assert set(rec) == {"cell", "arch", "shape", "mesh", "chips", "memory_analysis",
                        "roofline", "compile_seconds"}
    r = rec["roofline"]
    assert _finite_roofline(r) and rec["memory_analysis"]["per_device_total_gib"] > 0
    table_bytes = 8 * 932_096 * 64 * 4
    gathered = r["collective_breakdown"].get("all-gather", 0)
    if variant.get("shardmap_bag"):
        assert gathered < table_bytes / 16
    else:
        assert gathered >= table_bytes * (1 - variant.get("hot_fraction", 0.0)) * 15 / 16


def test_command_line_writes_records_the_report_renders(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "dlrm-recross", "--mesh", "single", "--results-dir", str(tmp_path)],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "OK  dlrm-recross__train_rec__pod16x16" in run.stdout
    rec = json.loads((tmp_path / "dlrm-recross__train_rec__pod16x16.json").read_text())
    assert rec["chips"] == 256
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.report", "--dir",
                          str(tmp_path), "--section", "dryrun"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "| dlrm-recross__train_rec__pod16x16 | 256 |" in out.stdout


# ------------------------------------------------------------ the counters --


@pytest.fixture
def world1():
    """A gloo world of one process (this one), ended after the test."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_collective_counter_counts_result_bytes_at_every_trip(world1):
    """For the reference's HLO parser tests: one bf16 (128, 64) all-reduce
    is 16,384 B of ``all-reduce``; inside a 7-trip loop, 7 times that."""
    from torch.distributed import _functional_collectives as fc

    x = torch.ones((128, 64), dtype=torch.bfloat16)
    for trips in (1, 7):
        counter = CollectiveCounter()
        with counter:
            for _ in range(trips):
                y = fc.wait_tensor(fc.all_reduce(x, "sum", dist.group.WORLD))
        assert counter.breakdown() == {"all-reduce": trips * 128 * 64 * 2}
        assert torch.equal(y, x)


def test_step_counter_sees_each_op_once_on_local_shards():
    """A DTensor matmul on (2, 2) counts the FLOPs of the rank's local
    product, as ``FlopCounterMode`` counts that product, on its first call
    (when DTensor's sharding propagation runs the op on global-shape fakes)
    as on later ones."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        torch.zeros(32, 32) @ torch.zeros(32, 8)
    with dryrun.fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        a = sh.shard_tensor(torch.zeros(64, 32, device="meta"), mesh, sh.P("data", None))
        b = sh.shard_tensor(torch.zeros(32, 16, device="meta"), mesh, sh.P(None, "model"))
        for _ in range(2):
            counter = StepCounter()
            with counter:
                a @ b
            assert counter.flops == fc.get_total_flops() == 2 * 32 * 32 * 8
            assert counter.bytes == (32 * 32 + 32 * 8 + 32 * 8) * 4


def test_fake_world_refuses_a_running_world_of_another_backend(world1):
    with pytest.raises(RuntimeError, match="fake"):
        with dryrun.fake_world(4):
            pass
    assert dist.get_backend() == "gloo"
