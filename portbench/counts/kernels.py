"""The port's hand-written kernels by name, and the work of the ones
whose work the shapes fix, frozen at the commit that added the
benchmark. A device trace names CUDA kernels; a name belongs to Kn when
it holds one of Kn's substrings (the bf16 Hopper kernels, their merges
and pre-passes, and the fp32 kernels that only parity checks run).

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense): 989 TFLOP/s
bf16, 495 TFLOP/s TF32, 67 TFLOP/s fp32 outside the tensor cores, HBM
3.35 TB/s. A kernel's least time is the larger of its operations over
the peak and its bytes (each input read once, each output written once)
over the bandwidth.
"""

from __future__ import annotations

PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

KERNELS = {
    "K1": ("smallq_kernel", "smallq_fwd_wgmma_kernel", "smallq_merge_kernel"),
    "K2": ("largeq_kernel", "largeq_fwd_wgmma_kernel"),
    "K3": ("head_sample_kernel", "head_sample_wgmma_kernel", "head_sample_merge_kernel"),
    "K4": ("head_topk_sample_kernel", "head_topk_wgmma_kernel", "head_topk_merge_kernel"),
    "K5": ("head_topk_sample_v1_kernel", "head_topk_v1_wgmma_kernel"),
    "K6": ("smallq_bwd_dq_kernel", "smallq_bwd_dq_wgmma_kernel", "smallq_bwd_dq_merge_kernel",
           "smallq_bwd_live_kernel", "attn_bwd_dkdv_kernel", "smallq_bwd_dkdv_wgmma_kernel"),
    "K7": ("largeq_bwd_dq_kernel", "largeq_bwd_dq_wgmma_kernel",
           "largeq_bwd_dkdv_wgmma_kernel", "largeq_bwd_dkdv_merge_kernel"),
    "K9": ("nearest_code_wgmma_kernel", "nearest_code_merge_kernel",
           "nearest_code_split_kernel"),
}

# the spin kernels a trace starts with (torch.cuda._sleep)
SPIN = "spin_kernel"


def kernel_of(name: str) -> str | None:
    """K1..K9 for a kernel of the port, else None. K6's fp32 dk/dv pass
    (`attn_bwd_dkdv_kernel`) is also K7's fp32 one; no profiled path is
    fp32, so it counts under K6."""
    for k, keys in KERNELS.items():
        if any(key in name for key in keys):
            return k
    return None


def head_ops(rows: int, D: int, V: int) -> int:
    """K3 / K4: the (rows, D) x (D, V) head product, 2 R D V."""
    return 2 * rows * D * V


def k2_work(B: int, H: int, NQ: int, NK: int, Dh: int, bytes_el: int = 2) -> tuple[int, int]:
    """K2 forward: (ops, bytes); S = Q K^T and O = P V, q, k, v in, o out."""
    return 4 * B * H * NQ * NK * Dh, bytes_el * B * H * Dh * (2 * NQ + 2 * NK)


def k7_work(B: int, H: int, NQ: int, NK: int, Dh: int, bytes_el: int = 2) -> tuple[int, int]:
    """K7 backward: (ops, bytes); five products (S, dP, dV, dQ, dK),
    q, k, v, o, dO and the fp32 lse in, dq, dk, dv out."""
    ops = 10 * B * H * NQ * NK * Dh
    elems_in = B * H * Dh * (3 * NQ + 2 * NK)
    elems_out = B * H * Dh * (NQ + 2 * NK)
    return ops, bytes_el * (elems_in + elems_out) + 4 * B * H * NQ


def least_seconds(ops: float, nbytes: float, peak_ops: float = PEAK_BF16) -> float:
    return max(ops / peak_ops, nbytes / PEAK_BYTES)
