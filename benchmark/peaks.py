"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at its full 700 W power limit).  A card set below that
limit runs slower under load: every share of a peak is printed beside the
card's power limit."""

H100 = {
    "bf16_flops": 989e12,
    "tf32_flops": 495e12,
    "f32_flops": 67e12,
    "hbm_bytes_per_s": 3.35e12,
    "hbm_bytes": 80e9,
}
