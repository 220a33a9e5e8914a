"""Published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, no
sparsity), at its full power limit of 700 W.  A card set below that limit
runs slower under load; the benchmark prints the card's ``power.limit``
beside every share it reports against these numbers."""

BF16_FLOPS = 989e12          # tensor cores, bf16 and fp16
F32_FLOPS = 67e12            # CUDA cores, float32 outside the tensor cores
HBM_BYTES = 3.35e12          # device memory bandwidth, bytes a second
