"""bss2 — the paper's own machine: BrainScaleS-2 full-size ASIC model.

512 AdEx neuron circuits, 131072 synapses (256 rows x 512 columns, 4
quadrants), 2 PPUs, CADC per column, analog parameter storage (capmem).
Hardware acceleration factor 1000x vs biology: all time constants below are
in MODEL time (us of emulated hardware time).

Copy of ``repro/configs/bss2.py``, with its ``ArchConfig`` shim
``BSS2_ARCH`` registered in ``repro_torch.config`` so both registries hold
the same names.
"""
from dataclasses import dataclass, field, replace

from repro_torch.config import ArchConfig, register


@dataclass(frozen=True)
class NeuronParams:
    """AdEx parameters (model-time units: us, nS, pF, mV)."""
    c_mem: float = 200.0          # membrane capacitance [pF]
    g_leak: float = 20.0          # leak conductance [nS] -> tau_m = 10 us
    e_leak: float = -65.0         # leak reversal [mV]
    e_reset: float = -70.0        # reset potential [mV]
    v_thres: float = -50.0        # spike threshold [mV]
    v_exp: float = -54.0          # exponential soft threshold [mV]
    delta_t: float = 2.0          # exponential slope [mV]
    tau_w: float = 100.0          # adaptation time constant [us]
    a: float = 4.0                # subthreshold adaptation [nS]
    b: float = 20.0               # spike-triggered adaptation increment [pA]
    tau_refrac: float = 2.0       # refractory period [us]
    tau_syn_exc: float = 5.0      # excitatory synaptic time constant [us]
    tau_syn_inh: float = 5.0      # inhibitory synaptic time constant [us]
    e_syn_exc: float = 0.0        # only used in COBA mode
    e_syn_inh: float = -80.0
    adex: bool = True             # False -> plain LIF


@dataclass(frozen=True)
class MismatchParams:
    """Transistor-mismatch model for virtual instances (relative sigmas)."""
    sigma_g_leak: float = 0.15
    sigma_tau_syn: float = 0.10
    sigma_v_thres: float = 1.5    # absolute [mV]
    sigma_weight_gain: float = 0.20   # synaptic DAC gain spread
    sigma_stp_offset: float = 0.25    # STP efficacy offset (Fig. 4 target)
    sigma_cadc_offset: float = 4.0    # CADC per-column offset [LSB]
    sigma_cadc_gain: float = 0.05
    sigma_capmem: float = 0.05        # analog parameter storage cell spread


@dataclass(frozen=True)
class BSS2Config:
    name: str = "bss2"
    n_neurons: int = 512
    n_rows: int = 256             # synapse rows (drivers)
    n_cols: int = 512             # synapse columns == neurons
    weight_bits: int = 6
    address_bits: int = 6
    cadc_bits: int = 8
    calib_bits: int = 4           # STP offset calibration code width (Fig. 4)
    dt: float = 0.2               # integration step [us model time]
    speedup: float = 1000.0       # acceleration factor vs biology
    ppu_clock_mhz: float = 400.0  # measured silicon value (paper Sec. 4.5)
    neuron: NeuronParams = field(default_factory=NeuronParams)
    mismatch: MismatchParams = field(default_factory=MismatchParams)
    # STP (Tsodyks-Markram) defaults
    stp_u: float = 0.2            # utilization
    stp_tau_rec: float = 20.0     # recovery time constant [us]

    @property
    def n_synapses(self) -> int:
        return self.n_rows * self.n_cols

    def reduced(self) -> "BSS2Config":
        return replace(self, n_neurons=16, n_rows=16, n_cols=16)


BSS2 = BSS2Config()
assert BSS2.n_synapses == 131072  # paper: "512 neurons and 130K synapses"

# Thin ArchConfig shim so `--arch bss2` works in the launcher/dry-run.
BSS2_ARCH = register(ArchConfig(
    name="bss2",
    family="neuromorphic",
    n_layers=1,
    d_model=512,          # neurons
    n_heads=0,
    n_kv_heads=0,
    d_ff=256,             # synapse rows
    vocab=0,
    tie_embeddings=False,
    source="this paper (Gruebl et al. 2020); full-size BSS-2 ASIC",
))
