"""The port's quickstart (``repro_torch.launch.quickstart``) and its CPU
baseline (``repro_torch.core.simulate_cpu_baseline``) on the CPU against
``repro``.

``simulate_cpu_baseline`` is host NumPy in both packages, so its report
must equal the reference's field for field, exactly.  The quickstart's
numbers must equal those of ``examples/quickstart.py``'s pipeline,
computed here by calling ``repro.core`` directly, and its reduction
(the kernel's plain version on the CPU) must match JAX's
``reduce_dense_oracle`` at the f32 tolerance of
``tests/test_kernels.py``.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as jcore
from repro.core.reduction import reduce_dense_oracle as jax_dense_oracle
from repro.data import zipf_queries
from repro_torch.core import simulate_cpu_baseline
from repro_torch.core.energy import ReRAMCostModel
from repro_torch.launch import quickstart

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_ATOL = 1e-5  # tests/test_kernels.py


def _assert_reports_equal(port, ref):
    for f in dataclasses.fields(ref):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert type(a) is type(b) and a == b, (f.name, a, b)


@pytest.mark.parametrize("seed,n,lanes", [(0, 256, 8), (3, 97, 1), (5, 500, 16)])
def test_cpu_baseline_equals_reference(seed, n, lanes):
    queries = zipf_queries(2048, n, 12.0, seed=seed)
    # a repeated row in a query is fetched once
    queries[0] = np.concatenate([queries[0], queries[0][:3]])
    _assert_reports_equal(
        simulate_cpu_baseline(queries, parallel_lanes=lanes),
        jcore.simulate_cpu_baseline(queries, parallel_lanes=lanes),
    )


def test_cpu_baseline_empty_and_custom_model_equal_reference():
    _assert_reports_equal(simulate_cpu_baseline([]), jcore.simulate_cpu_baseline([]))
    queries = zipf_queries(512, 64, 6.0, seed=9)
    kw = dict(dram_fetch_ns=80.0, dram_fetch_energy_pj=1500.0)
    _assert_reports_equal(
        simulate_cpu_baseline(queries, model=ReRAMCostModel(**kw)),
        jcore.simulate_cpu_baseline(queries, model=jcore.ReRAMCostModel(**kw)),
    )


@pytest.fixture(scope="module")
def run():
    return quickstart.main(device="cpu")


def test_quickstart_numbers_equal_the_reference_pipeline(run):
    n, dim, group = quickstart.NUM_ROWS, quickstart.DIM, quickstart.GROUP
    history = zipf_queries(n, 512, mean_bag=20.0, seed=0)
    online = zipf_queries(n, 256, mean_bag=20.0, seed=1)
    graph = jcore.build_cooccurrence(history, n)
    layout, recross = jcore.baselines.recross_pipeline(
        graph, online, group_size=group, dim=dim, batch_size=256)
    _, counts = jcore.query_tile_bitmaps(layout, online[:256])
    _, naive = jcore.baselines.naive_pipeline(n, online)
    _, nmars = jcore.baselines.nmars_pipeline(n, online)
    cpu = jcore.simulate_cpu_baseline(online)
    want = {
        "device": "cpu",
        "edges": graph.edge_count(),
        "groups": layout.num_groups,
        "tiles": layout.num_tiles,
        "read_fraction": jcore.mode_statistics(counts)["read_fraction"],
        "speedup_vs_naive": recross.speedup_over(naive),
        "speedup_vs_nmars": recross.speedup_over(nmars),
        "energy_vs_naive": recross.energy_efficiency_over(naive),
        "energy_vs_cpu": cpu.energy_pj / recross.energy_pj,
    }
    assert {k: run[k] for k in want} == want
    assert run["max_abs_err"] <= quickstart.ATOL


def test_quickstart_reduction_matches_jax_dense_oracle(run):
    online = zipf_queries(quickstart.NUM_ROWS, 256, mean_bag=20.0, seed=1)
    table = np.random.default_rng(0).normal(
        size=(quickstart.NUM_ROWS, quickstart.DIM)).astype(np.float32)
    want = np.asarray(jax_dense_oracle(jnp.asarray(table),
                                       online[:quickstart.KERNEL_QUERIES]))
    got = run["out"].numpy()
    assert got.shape == want.shape == (quickstart.KERNEL_QUERIES, quickstart.DIM)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


def test_quickstart_cli_prints_its_numbers():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.quickstart", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["device"] == "cpu" and res["max_abs_err"] <= quickstart.ATOL
    assert res["tiles"] >= res["groups"] > 0
