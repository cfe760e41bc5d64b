"""The slice as a whole: ``repro_torch.serve.ShardedEmbeddingServer`` on
the CPU against ``repro.serve.ShardedEmbeddingServer(mesh=None)``.

Integer-valued tables make every partial sum exact, so each flush's rows
must be bit-identical; the port's plan and shard images must equal the
reference server's byte for byte.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.data import zipf_queries
from repro.serve import ShardedEmbeddingServer as JaxServer
from repro_torch.convert import shard_images_from_numpy, tables_from_numpy
from repro_torch.serve import FaultPlan, ReplanConfig, TierConfig
from repro_torch.serve import ShardedEmbeddingServer as TorchServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DETERMINISTIC_SERVE_FIELDS = (
    "num_shards", "q_block", "flush_policy", "batches", "queries", "blocks",
    "grid_cells_per_shard", "max_grid_cells_per_flush", "max_shard_width",
    "combine_bytes", "participant_sizes",
)


def _int_table(rows, dim, seed):
    """Integer-valued f32 table: partial sums are exact in float32."""
    return np.random.default_rng(seed).integers(-8, 9, size=(rows, dim)).astype(np.float32)


def _setup(seed):
    rows = {"a": 192, "b": 512}
    tables = {n: _int_table(r, 128, seed + i) for i, (n, r) in enumerate(rows.items())}
    histories = {
        n: zipf_queries(r, 64, 6.0, seed=seed + 10 + i)
        for i, (n, r) in enumerate(rows.items())
    }
    stream = [
        ("a" if i % 3 else "b", q)
        for i, q in enumerate(zipf_queries(192, 30, 6.0, seed=seed + 20))
    ]
    return tables, histories, stream


def _drive(server, stream):
    flushes = []
    for name, q in stream:
        out = server.submit(name, q)
        if out:
            flushes.append(out)
    tail = server.flush()
    if tail:
        flushes.append(tail)
    return flushes


@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_server_bit_identical_to_reference(num_shards):
    tables, histories, stream = _setup(seed=7 * num_shards)
    kw = dict(num_shards=num_shards, q_block=4, group_size=16, batch_size=12)
    ref = JaxServer(tables, histories, mesh=None, **kw)
    port = TorchServer(tables_from_numpy(tables, "cpu"), histories, device="cpu", **kw)

    np.testing.assert_array_equal(
        shard_images_from_numpy(np.asarray(ref.shard_images), "cpu").numpy(),
        port.shard_images.numpy(),
    )
    got_ref, got_port = _drive(ref, stream), _drive(port, stream)
    assert len(got_ref) == len(got_port) >= 3
    for fr, fp in zip(got_ref, got_port):
        assert sorted(fr) == sorted(fp)
        for name in fr:
            assert fp[name].device.type == "cpu"
            np.testing.assert_array_equal(np.asarray(fr[name]), fp[name].numpy())

    rr, rp = ref.report(), port.report()
    assert rr["plan"] == rp["plan"]
    assert rr["tables"] == rp["tables"] and rr["mode"] == rp["mode"] == "emulated"
    for key in DETERMINISTIC_SERVE_FIELDS:
        assert rr["serve"][key] == rp["serve"][key], key
    assert set(rr["dispatch_cache"]) == set(rp["dispatch_cache"])
    assert rp["image_bytes"] == np.asarray(ref.shard_images).nbytes


def test_bf16_tables_keep_their_dtype():
    tables, histories, stream = _setup(seed=3)
    port = TorchServer(
        {n: t.to(torch.bfloat16) for n, t in tables_from_numpy(tables, "cpu").items()},
        histories, num_shards=2, q_block=4, group_size=16, batch_size=12,
        device="cpu",
    )
    assert port.shard_images.dtype == torch.bfloat16
    flushes = _drive(port, stream)
    # integer values below 2**8 stay exact in bf16: same rows as f32
    f32 = _drive(
        TorchServer(tables_from_numpy(tables, "cpu"), histories, num_shards=2,
                    q_block=4, group_size=16, batch_size=12, device="cpu"),
        stream,
    )
    for fb, ff in zip(flushes, f32):
        for name in ff:
            assert fb[name].dtype == torch.bfloat16
            np.testing.assert_array_equal(fb[name].float().numpy(), ff[name].numpy())


@pytest.mark.parametrize("kwargs,error,match", [
    # mesh= is ported: it takes a ShardMesh, one process per shard
    ({"mesh": object()}, TypeError, "ShardMesh"),
    # the async policies are ported: this case serves
    ({"flush_policy": "per-shard"}, None, None),
    # the reference's rule: the thread driver needs an async kind
    ({"threaded": True}, ValueError, "async kind"),
    # drift tracking and replanning are ported: this case serves
    ({"replan": ReplanConfig()}, None, None),
    # tiered storage and fault injection are ported: these cases serve
    ({"tiers": TierConfig(capacity_frac=0.5)}, None, None),
    ({"faults": FaultPlan([], seed=0).add("compile", tick=0)}, None, None),
    # the reference's rule: faults= takes a FaultPlan or a FaultInjector
    ({"faults": object()}, TypeError, "FaultPlan"),
])
def test_unported_modes_raise(kwargs, error, match):
    tables, histories, stream = _setup(seed=1)
    if error is not None:
        with pytest.raises(error, match=match):
            TorchServer(tables_from_numpy(tables, "cpu"), histories, device="cpu", **kwargs)
        return
    port = TorchServer(tables_from_numpy(tables, "cpu"), histories, q_block=4,
                       group_size=16, batch_size=12, device="cpu", **kwargs)
    # a "global" server returns rows from submit(); an async one only
    # from drain()
    parts = {"a": [], "b": []}
    for name, q in stream:
        out = port.submit(name, q)
        assert out == {} or port.scheduler is None
        for n, rows in out.items():
            parts[n].append(rows)
    for n, rows in port.drain().items():
        parts[n].append(rows)
    for name in ("a", "b"):
        qs = [q for n, q in stream if n == name]
        want = np.stack([tables[name][np.unique(q)].sum(axis=0) for q in qs])
        np.testing.assert_array_equal(torch.cat(parts[name]).numpy(), want)


def test_submit_validation_and_close():
    tables, histories, stream = _setup(seed=2)
    port = TorchServer(tables_from_numpy(tables, "cpu"), histories,
                       q_block=4, group_size=16, batch_size=64, device="cpu")
    with pytest.raises(KeyError):
        port.submit("zzz", [1])
    with pytest.raises(IndexError):
        port.submit("a", [0, 192])
    port.submit("a", [1, 2])
    port.close()
    with pytest.raises(RuntimeError):
        port.submit("a", [3])
    assert port.report()["serve"]["faults"]["lost_work"]["requeued"] == 1


def test_launcher_cpu_smoke_subprocess():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_sharded", "--device", "cpu",
         "--rows", "256", "--history", "128", "--requests", "48",
         "--batch-size", "16", "--shards", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert '"queries": 48' in proc.stdout
