"""The port's analytic cost model, H100 roofline and report renderer
against the JAX package's: ``launch.analytic`` bit for bit for every arch
and shape, the reference's roofline tests with the H100 constants, and
``launch.report`` rendering the same records to the same strings."""

import pytest

from repro.configs import ARCH_IDS, SHAPES as J_SHAPES, get_config as j_get_config
from repro.launch import analytic as j_analytic
from repro.launch import report as j_report
from repro.launch.roofline import model_flops_for as j_model_flops_for
from repro_torch.configs import SHAPES, get_config
from repro_torch.core import DEFAULT_H100, H100CostModel
from repro_torch.launch import analytic, report
from repro_torch.launch.roofline import RooflineReport, model_flops_for


def _costs(mod, cfg, shape):
    """Every function of an analytic module at every option, as floats."""
    b, s = shape.global_batch, shape.seq_len
    out = [mod.forward_flops(cfg, b, s, causal_skip=skip) for skip in (False, True)]
    for remat in (False, True):
        for opt in ("adamw", "adafactor"):
            c = mod.train_cost(cfg, shape, remat=remat, optimizer=opt)
            out += [c.flops, c.hbm_bytes, c.notes]
    c = mod.prefill_cost(cfg, shape)
    out += [c.flops, c.hbm_bytes, c.notes]
    for window in (None, 4096):
        for kv in (2.0, 1.125):
            c = mod.decode_cost(cfg, shape, window=window, kv_dtype_bytes=kv)
            out += [c.flops, c.hbm_bytes, c.notes]
    c = mod.cell_cost(cfg, shape)
    return out + [c.flops, c.hbm_bytes, c.notes]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_equals_the_reference_bit_for_bit(arch):
    for name in J_SHAPES:
        want = _costs(j_analytic, j_get_config(arch), J_SHAPES[name])
        got = _costs(analytic, get_config(arch), SHAPES[name])
        assert got == want, (arch, name)
        assert model_flops_for(get_config(arch), SHAPES[name]) == \
            j_model_flops_for(j_get_config(arch), J_SHAPES[name])


def test_h100_constants_follow_the_datasheet():
    m = DEFAULT_H100
    assert (m.peak_flops, m.peak_flops_f32, m.hbm_bandwidth, m.hbm_bytes) == \
        (989e12, 67e12, 3.35e12, 80e9)
    assert (m.nvlink_bandwidth, m.network_bandwidth, m.nvlink_domain) == (450e9, 50e9, 8)
    # one host's cards talk over NVLink, a mesh across hosts over the network
    assert m.collective_time(8e9, 8) == pytest.approx(8e9 / (8 * 450e9))
    assert m.collective_time(9e9, 9) == pytest.approx(9e9 / (9 * 50e9))
    assert m.compute_time(989e12, 2) == pytest.approx(0.5)
    assert m.memory_time(3.35e12, 1) == pytest.approx(1.0)
    assert isinstance(m, H100CostModel)


# ---- tests/test_roofline.py:96-127, with the H100 constants


def test_roofline_report_terms():
    rep = RooflineReport(
        arch="x", shape="train_4k", mesh="pod16x16", chips=256,
        hlo_flops=1e15, hlo_bytes=1e12, collective_bytes=1e12,
        collective_breakdown={}, analytic_flops=5.04e16, analytic_bytes=2e13,
    )
    # compute = 5.04e16/(256*989e12) ~ 2e-4 s — dominates the other terms
    assert abs(rep.compute_s - 5.04e16 / (256 * 989e12)) < 1e-9
    assert rep.memory_s == pytest.approx(2e13 / (256 * 3.35e12))
    assert rep.collective_s == pytest.approx(1e12 / (256 * 50e9))
    assert rep.dominant == "compute"
    assert rep.roofline_fraction == pytest.approx(1.0)
    assert rep.bound_time_s == rep.compute_s
    d = rep.to_dict()
    assert d["compute_s"] == rep.compute_s and d["dominant"] == "compute"
    assert d["useful_flops_ratio"] is None


@pytest.mark.parametrize("arch", ["minicpm-2b", "grok-1-314b", "zamba2-7b"])
def test_analytic_flops_close_to_6nd(arch):
    """Analytic forward FLOPs must land within 2.5x of 2·N_active·tokens
    (they include attention/routing overheads that 6ND ignores)."""
    cfg = get_config(arch)
    shape = SHAPES["train_4k"]
    fwd = analytic.forward_flops(cfg, shape.global_batch, shape.seq_len)
    six_nd = 2.0 * cfg.active_param_count() * shape.global_batch * shape.seq_len
    assert 0.7 <= fwd / six_nd <= 2.5, fwd / six_nd


def test_cell_cost_kinds():
    cfg = get_config("minicpm-2b")
    tr = analytic.cell_cost(cfg, SHAPES["train_4k"])
    pf = analytic.cell_cost(cfg, SHAPES["prefill_32k"])
    dc = analytic.cell_cost(cfg, SHAPES["decode_32k"])
    assert tr.flops > pf.flops > dc.flops
    assert dc.hbm_bytes > 0


# ---- launch.report against the reference's, on the same records


def _record(arch, shape, mesh, frac, coll_s, mem_gib, ratio=1.1, variant=None):
    cell = f"{arch}__{shape}__{mesh}" + (f"__{variant}" if variant else "")
    return {
        "cell": cell, "arch": arch, "shape": shape, "mesh": mesh,
        "chips": 512 if mesh == "pod2x16x16" else 256, "compile_seconds": 12.4,
        "memory_analysis": {"per_device_total_gib": mem_gib},
        "roofline": {"compute_s": 0.5 * frac, "memory_s": 2.5e-3, "collective_s": coll_s,
                     "dominant": "compute" if frac > 0.5 else "collective",
                     "roofline_fraction": frac, "useful_flops_ratio": ratio,
                     "collective_bytes": 3.5 * 2**30,
                     "collective_breakdown": {"all-gather": 2**31, "all-reduce": 2**30,
                                              "reduce-scatter": 2**29, "all-to-all": 7}},
    }


RECORDS = [
    _record("minicpm-2b", "train_4k", "pod16x16", 0.9, 0.01, 12.3),
    _record("minicpm-2b", "train_4k", "pod2x16x16", 0.8, 0.02, 8.1),
    _record("grok-1-314b", "decode_32k", "pod16x16", 0.02, 4e-5, 60.0, ratio=None),
    _record("dlrm-recross", "train_rec", "pod16x16", 0.001, 3e-4, 1.0, ratio=None),
    _record("zamba2-7b", "prefill_32k", "pod16x16", 0.4, 2.0, 3.3),
]


def test_report_renders_the_reference_strings(tmp_path):
    import json

    assert report.roofline_table(RECORDS) == j_report.roofline_table(RECORDS)
    assert report.roofline_table(RECORDS, "pod2x16x16") == \
        j_report.roofline_table(RECORDS, "pod2x16x16")
    assert report.dryrun_table(RECORDS) == j_report.dryrun_table(RECORDS)
    assert report.pick_hillclimb_cells(RECORDS) == j_report.pick_hillclimb_cells(RECORDS)
    assert report.pick_hillclimb_cells([]) == j_report.pick_hillclimb_cells([]) == {}
    for x in (3.0, 2.5e-2, 4e-5):
        assert report.fmt_s(x) == j_report.fmt_s(x)
    for r in RECORDS + [_record("minicpm-2b", "train_4k", "pod16x16", 0.5, 0.1, 1.0,
                                variant="sp")]:
        (tmp_path / f"{r['cell']}.json").write_text(json.dumps(r))
    for variants in (False, True):
        got = report.load_cells(str(tmp_path), include_variants=variants)
        assert got == j_report.load_cells(str(tmp_path), include_variants=variants)
        assert len(got) == len(RECORDS) + variants


def test_report_is_the_reference_line_for_line():
    """Apart from its docstring and ``--dir``'s default, the module is the
    reference's."""
    import inspect

    def body(mod):
        src = inspect.getsource(mod)
        return src[src.index('"""', 3) + 3:].replace('os.path.join("build", "dryrun")',
                                                     'os.path.join("experiments", "dryrun")')

    assert body(report).replace("repro_torch", "repro") == body(j_report)

