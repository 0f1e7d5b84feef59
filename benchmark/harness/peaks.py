"""Published peaks of one NVIDIA H100 SXM and the least time FAST with NMS
could take, frozen here as the yardstick (a copy of ``chip_smoke.py``'s
``fast_bound`` and its constants; the work counts come from
``reference/frontend.py`` ``fast_counts`` on the frames the window
served).
"""

from __future__ import annotations

# NVIDIA's H100 SXM data sheet: HBM bandwidth, and float32 outside the
# tensor cores, 67 TFLOP/s = 132 SMs x 128 lanes x 2 (an FMA) x 1.98 GHz.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
# Issue rates of the instructions the FAST kernel runs (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute
# capability 9.0): a float add or subtract 128 results per clock per SM,
# a compare, min, max or select 64; an SM issues at most 128 per clock.
SUB_OPS_S = PEAK_FP32_S / 2
CMP_OPS_S = PEAK_FP32_S / 4
INSTR_OPS_S = PEAK_FP32_S / 2


def fast_bound_ms(n_px: int, n_cand: int, n_corner: int) -> float:
    """The least time (ms) for FAST with NMS on inputs with these counts.
    Bytes: the image read once, the raw and NMS maps written once.
    Operations per pixel: the pre-test's 4 subtractions and 8 compares
    and the NMS select; per pixel that passes it, 12 more subtractions
    and 161 min/max/compare/select; per corner, the 8 NMS compares."""
    subs = 4 * n_px + 12 * n_cand
    cmps = 9 * n_px + 161 * n_cand + 8 * n_corner
    t_bytes = 3 * 4 * n_px / PEAK_BYTES_S * 1e3
    t_ops = max(subs / SUB_OPS_S, cmps / CMP_OPS_S,
                (subs + cmps) / INSTR_OPS_S) * 1e3
    return max(t_bytes, t_ops)
