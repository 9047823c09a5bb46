"""Translation of predicted output length to system metrics (§III.B, Eq. 2-3)
via calibrated per-model profiles; the port's copy of
``repro/core/predictor/cost_model.py`` (``HardwareSpec``, ``A100_40G``,
``ModelProfile``, ``profile_from_arch``, ``synthetic_profile``).

    T_exec(T) = t_pre(P, M) + t_dec(M) * L_hat          (Eq. 2)
    R_kv(T)   = alpha(M) * (P + L_hat)                  (Eq. 3)

Prefill is modelled compute-bound (2*N_active*P / peak), decode memory-bound
(weights + KV read per token / HBM bandwidth). The default hardware is the
card the port runs on, one NVIDIA H100 SXM5 80 GB.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str = "h100-sxm5-80g"
    # NVIDIA H100 SXM5 data sheet: dense bf16 tensor-core peak, HBM3
    # bandwidth and capacity
    peak_flops: float = 989e12       # bf16
    hbm_bw: float = 3.35e12          # bytes/s
    hbm_capacity: float = 80e9
    # host<->device staging: PCIe Gen5 x16 nominal, one direction (the
    # data sheet's 128 GB/s counts both); chip_smoke.py measures the
    # pinned host-to-device rate the card really reaches
    host_link_bw: float = 64e9
    # modelling assumptions kept from the reference, not measurements
    disk_bw: float = 3e9
    remote_bw: float = 1e9
    mfu: float = 0.5                 # realized fraction of peak in prefill
    mbu: float = 0.7                 # realized fraction of HBM bw in decode


A100_40G = HardwareSpec(name="a100-40g", peak_flops=312e12, hbm_bw=1555e9,
                        hbm_capacity=40e9, host_link_bw=25e9)


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """Calibrated per-model microbenchmark (Eq. 2-3 inputs)."""
    name: str
    weight_bytes: int
    ctx_bytes: int                   # persistent warm context (M_ctx^k)
    alpha_bytes_per_token: int       # KV footprint per token (Eq. 3)
    state_bytes: int                 # constant per-seq state (SSM archs)
    prefill_flops_per_token: float
    decode_bytes_per_token: float    # HBM bytes read per generated token
    hw: HardwareSpec

    def t_prefill(self, prompt_len: int) -> float:
        return (prompt_len * self.prefill_flops_per_token
                / (self.hw.peak_flops * self.hw.mfu))

    @property
    def t_decode(self) -> float:
        """Seconds per generated token (batch-1 lower bound)."""
        return self.decode_bytes_per_token / (self.hw.hbm_bw * self.hw.mbu)

    def t_exec(self, prompt_len: int, pred_len: float) -> float:
        """Eq. 2."""
        return self.t_prefill(prompt_len) + self.t_decode * pred_len

    def r_kv(self, prompt_len: int, pred_len: float) -> float:
        """Eq. 3 (+ constant recurrent state for SSM archs)."""
        return (self.alpha_bytes_per_token * (prompt_len + pred_len)
                + self.state_bytes)


def profile_from_arch(cfg: ArchConfig, hw: HardwareSpec = HardwareSpec(),
                      ctx_bytes: int = 256 << 20) -> ModelProfile:
    n_active = cfg.active_param_count()
    alpha = cfg.kv_bytes_per_token()
    return ModelProfile(
        name=cfg.name,
        weight_bytes=cfg.weight_bytes(),
        ctx_bytes=ctx_bytes,
        alpha_bytes_per_token=alpha,
        state_bytes=cfg.ssm_state_bytes(),
        prefill_flops_per_token=2.0 * n_active,
        # decode reads active weights once per token + amortized KV walk
        decode_bytes_per_token=2.0 * n_active + alpha * 1024,
        hw=hw,
    )


def synthetic_profile(name: str, params_b: float,
                      hw: HardwareSpec = HardwareSpec(),
                      n_layers: int = 32, n_kv: int = 8, head_dim: int = 128,
                      ctx_bytes: int = 200 << 20) -> ModelProfile:
    """Profile for a model named only by size (the sim's small Qwen3 zoo)."""
    n = params_b * 1e9
    alpha = int(n_layers * 2 * n_kv * head_dim * 2)
    return ModelProfile(
        name=name, weight_bytes=int(2 * n), ctx_bytes=ctx_bytes,
        alpha_bytes_per_token=alpha, state_bytes=0,
        prefill_flops_per_token=2.0 * n,
        decode_bytes_per_token=2.0 * n + alpha * 1024, hw=hw)
