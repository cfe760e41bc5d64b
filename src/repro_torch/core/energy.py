"""Latency / energy cost model of the paper's ReRAM hardware.

:class:`ReRAMCostModel` — a NeuroSIM-flavoured analytic model of the
paper's hardware (22 nm, 64×64 crossbar, 2-bit cells, 6-bit flash ADC,
dynamic-switch ADC with popcount).  It reproduces the *relative* numbers
of the paper's figures (speedup / energy-efficiency ratios); absolute
constants are taken from the NeuroSIM / ISAAC / flash-ADC literature the
paper cites and are documented per field.  The simulator
(:mod:`repro_torch.core.simulator`) charges events against it.

:class:`H100CostModel` — the roofline constants of one NVIDIA H100 SXM
card, used by :mod:`repro_torch.launch.roofline` where the reference's
``TPUCostModel`` stands.

A NumPy copy of the ReRAM half of ``repro.core.energy``; the port keeps
its own so that it never imports the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ReRAMCostModel:
    """Analytic ReRAM crossbar cost model (paper Table I hardware).

    Latency unit: nanoseconds.  Energy unit: picojoules.

    Field provenance:
      * crossbar 64x64, 2-bit cells, 6-bit ADC, 256x256 tile, 512b bus —
        paper Table I.
      * MAC read pulse ~10 ns and array read energy — ISAAC [20] /
        NeuroSIM [27] 22nm-class numbers.
      * flash ADC: 2^n - 1 comparators; energy scales ~2^n — paper §III-D
        and Razavi [30].  6-bit MAC mode uses 63 comparators; READ mode
        uses 3-bit effective resolution (7 comparators, the paper reports
        "utilizing only 3 bits instead of the full 6-bit resolution").
      * popcount circuit: monolithic-3D CIM popcount [32]; tiny vs ADC.
    """

    rows: int = 64
    cols: int = 64
    bits_per_cell: int = 2
    adc_bits: int = 6
    read_adc_bits: int = 3

    # -- latency (ns) --
    mac_latency_ns: float = 10.0       # one full-array MAC incl. ADC conversion
    read_latency_ns: float = 5.0       # single-wordline read, low-res ADC path
    adc_latency_ns: float = 1.0        # flash ADC conversion (parallel, fast)
    popcount_latency_ns: float = 0.3   # [32]
    bus_cycle_ns: float = 1.0          # 512b global bus transfer per tile result
    dram_fetch_ns: float = 100.0       # host-side row fetch (CPU baseline path)

    # -- energy (pJ) --
    cell_mac_energy_pj: float = 0.0002   # per cell per MAC (22nm ReRAM)
    cell_read_energy_pj: float = 0.0001  # per cell per read
    comparator_energy_pj: float = 0.04   # per comparator per conversion
    popcount_energy_pj: float = 0.05     # per activation decision [32]
    wordline_driver_energy_pj: float = 0.01  # per driven wordline
    bus_energy_pj: float = 0.8           # per 512b transfer
    dram_fetch_energy_pj: float = 2000.0  # per 64B DRAM row fetch (CPU path)

    # ---- derived per-event costs ----------------------------------------

    @property
    def comparators_mac(self) -> int:
        return (1 << self.adc_bits) - 1  # 63

    @property
    def comparators_read(self) -> int:
        return (1 << self.read_adc_bits) - 1  # 7

    def adc_energy(self, mac_mode: bool) -> float:
        """Energy of one column conversion in MAC vs READ mode (pJ)."""
        n = self.comparators_mac if mac_mode else self.comparators_read
        return n * self.comparator_energy_pj

    def crossbar_mac_event(self, active_rows: int) -> tuple[float, float]:
        """(latency_ns, energy_pj) of one crossbar MAC activation.

        All ``cols`` columns convert; ``active_rows`` wordlines are driven;
        every cell on an active wordline dissipates MAC energy.
        """
        lat = self.mac_latency_ns + self.adc_latency_ns + self.popcount_latency_ns
        energy = (
            active_rows * self.cols * self.cell_mac_energy_pj
            + active_rows * self.wordline_driver_energy_pj
            + self.cols * self.adc_energy(mac_mode=True)
            + self.popcount_energy_pj
            + self.bus_energy_pj
        )
        return lat, energy

    def crossbar_read_event(self) -> tuple[float, float]:
        """(latency_ns, energy_pj) of one single-row READ activation."""
        lat = self.read_latency_ns + self.adc_latency_ns + self.popcount_latency_ns
        energy = (
            self.cols * self.cell_read_energy_pj
            + self.wordline_driver_energy_pj
            + self.cols * self.adc_energy(mac_mode=False)
            + self.popcount_energy_pj
            + self.bus_energy_pj
        )
        return lat, energy

    def crossbar_static_mac_event(self, active_rows) -> tuple[float, float]:
        """MAC event *without* dynamic switching (nMARS / naive ADС path).

        Always pays the full 6-bit conversion even for one active row, and
        no popcount circuit exists.  ``active_rows`` may be an int or an
        int array (the vectorized simulator charges whole batches at once;
        all event formulas are affine in the row count).
        """
        lat = self.mac_latency_ns + self.adc_latency_ns
        floor_rows = np.maximum(active_rows, 1)
        energy = (
            floor_rows * self.cols * self.cell_mac_energy_pj
            + floor_rows * self.wordline_driver_energy_pj
            + self.cols * self.adc_energy(mac_mode=True)
            + self.bus_energy_pj
        )
        return lat, energy

    def cpu_reduction_event(self, rows: int) -> tuple[float, float]:
        """Host CPU gathers `rows` rows from DRAM and sums them (baseline Fig. 11)."""
        lat = rows * self.dram_fetch_ns
        energy = rows * self.dram_fetch_energy_pj
        return lat, energy


@dataclasses.dataclass(frozen=True)
class H100CostModel:
    """Roofline constants of one NVIDIA H100 SXM5 80 GB card (NVIDIA's H100
    Tensor Core GPU datasheet; dense rates, no sparsity, at the 700 W
    power limit).

    ``collective_time`` charges NVLink for a mesh of at most
    ``nvlink_domain`` cards (the 8 cards of one HGX host, joined all to
    all) and the network link of each card beyond it: the 256- and
    512-card production meshes span hosts, so their collectives run at
    the network's rate.
    """

    peak_flops: float = 989e12          # bf16 / f16 dense tensor-core FLOP/s (SXM)
    peak_flops_f32: float = 67e12       # f32 FLOP/s outside the tensor cores (SXM)
    hbm_bandwidth: float = 3.35e12      # B/s, HBM3 (SXM)
    hbm_bytes: float = 80e9             # HBM capacity (SXM)
    nvlink_bandwidth: float = 450e9     # B/s each way, NVLink 4 (900 GB/s total) in one host
    network_bandwidth: float = 50e9     # B/s a card across hosts: one NDR 400 Gb/s NIC each
    nvlink_domain: int = 8              # cards an HGX H100 host joins by NVLink

    def compute_time(self, flops: float, chips: int) -> float:
        return flops / (chips * self.peak_flops)

    def memory_time(self, bytes_: float, chips: int) -> float:
        return bytes_ / (chips * self.hbm_bandwidth)

    def collective_time(self, bytes_: float, chips: int) -> float:
        link = self.nvlink_bandwidth if chips <= self.nvlink_domain else self.network_bandwidth
        return bytes_ / (chips * link)


DEFAULT_RERAM = ReRAMCostModel()
DEFAULT_H100 = H100CostModel()
