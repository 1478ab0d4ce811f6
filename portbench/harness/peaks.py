"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
power limit).  A card set to a lower limit runs under them; PERF.md gives
each run's limit beside its shares."""

BF16_FLOPS = 989e12          # bf16 / fp16 tensor cores
HBM_BYTES = 3.35e12          # HBM3 bandwidth
