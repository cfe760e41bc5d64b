"""The harness: BENCHMARK.json keeps the contract, a new traffic mix and
its cell are data alone, and a broken timed path, or the control, comes
out not correct."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from _recbench_tiny import ROOT, make_root, run_tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["recbench"] and bench["command"] == ["python3", "recbench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("recbench/configs/") and (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and "assumed" in cfg
        # the kernel's width rule: rows served at a multiple of 128 columns
        assert cfg["embed_dim"] <= cfg["padded_dim"] and cfg["padded_dim"] % 128 == 0
        assert set(cfg["limits"]) == {"failed_requests", "max_abs_err", "pad_nonzero"}
    cells = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "recbench/traffic" / f"{w['traffic']}.json").is_file()
        cells.add(w["name"])
    assert {c["config"] for c in bench["workloads"]} == set(configs)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "recbench/metrics" / f"{m['name']}.py").is_file()
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells and m["layer"]


def test_a_new_mix_and_cell_are_data_alone(tmp_path):
    burst = {"kind": "templates", "zipf_a": 1.2, "template_zipf": 1.3, "rows_per_template": 32,
             "rows_per_cluster": 128, "in_cluster_p": 0.95, "samples_per_request": 16}
    root = make_root(tmp_path, mixes={"burst": burst})
    bench = json.loads((root / "BENCHMARK.json").read_text())
    line, run = run_tiny(root, "tiny.burst")
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {m["name"] for m in bench["end_to_end"]}
    assert list(line)[-1] == "checks"
    assert run["samples"] == 16 * line["attempted"]
    line, run = run_tiny(root, "tiny.burst", traced=True)
    assert line["correct"]
    # on the CPU only the host readers and those of the program's spans and
    # counters find something to read
    assert set(line["metrics"]) == {"plan.build_s", "compile.host_ms_per_request", "serve.mfu",
                                    "compile.activations_ms_per_request", "plan.cooccurrence_s",
                                    "plan.grouping_s", "kernel.read_slot_share"}
    assert line["device"]["window_s"] > 0 and "device_ops" in line["breakdown"]


def _broken(monkeypatch, fault):
    from repro_torch.serve.sharded import ShardedEmbeddingServer

    serve = ShardedEmbeddingServer.serve
    state = {"calls": 0, "last": None}

    def broken(self, request):
        state["calls"] += 1
        if fault == "stale":
            # a step that returns its state unchanged: the work is done,
            # the previous answer comes back
            out = serve(self, request)
            last, state["last"] = state["last"], out
            return last if last is not None else out
        if fault == "half":
            # half of the batch left out
            half = {n: bags[: len(bags) // 2] for n, bags in request.items()}
            out = serve(self, half)
            return {n: torch.cat([rows, torch.zeros_like(rows)]) for n, rows in out.items()}
        if fault == "altered":
            # one answer altered where it is produced: a row id of one bag
            name = sorted(request)[0]
            bags = list(request[name])
            bags[0] = np.unique(np.append(bags[0][1:], (bags[0][0] + 1) % 4096))
            return serve(self, {**request, name: bags})
        if fault == "raises" and state["calls"] > 4 and state["calls"] % 2 == 0:
            raise RuntimeError("planted fault")
        return serve(self, request)

    monkeypatch.setattr(ShardedEmbeddingServer, "serve", broken)


@pytest.mark.parametrize("fault", ["stale", "half", "altered", "raises"])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, fault):
    _broken(monkeypatch, fault)
    line, _ = run_tiny(tiny_root, "tiny.cooc")
    assert line["attempted"] >= 2
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("workload", ["tiny.cooc", "tiny.indep"])
def test_the_control_is_not_correct(tiny_root, workload):
    """The control at a test's size: the program's bfloat16 path."""
    line, _ = run_tiny(tiny_root, workload, dtype=torch.bfloat16)
    assert line["checks"]["failed_requests"]["value"] == 0
    assert not line["correct"], line["checks"]
    line, _ = run_tiny(tiny_root, workload)
    assert line["correct"], line["checks"]


def test_no_card_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this test holds the harness without one")
    out = subprocess.run([sys.executable, str(ROOT / "recbench/run.py"), "--workload",
                          "automotive.serve-cooc", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""



@pytest.mark.parametrize("mask,want", [({0, 1, 2, 3, 4, 5, 6, 7}, {4, 5, 6, 7}),
                                       ({1, 3}, {1, 3}), ({0, 2, 5, 9, 11}, {2, 5, 9, 11})])
def test_the_process_takes_the_highest_cpus_of_its_mask(mask, want):
    from recbench import run

    assert run.host_cpus(mask) == want


def test_the_result_line_reports_host_and_footprint(tiny_root):
    line, run = run_tiny(tiny_root, "tiny.cooc")
    assert line["host"]["cpus"] == sorted(os.sched_getaffinity(0))
    assert line["host"]["plan_build_s"] == run["plan_build_s"] > 0
    assert set(line["footprint"]) == {"server_bytes", "image_bytes", "window_peak_bytes"}
    assert list(line)[-1] == "checks"
