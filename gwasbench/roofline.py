"""The least time one call's device work could take on one H100.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at
the full 700 W): 3.35 TB/s of device memory, 1,979 TOP/s of int8 on the
tensor cores.

The counts are lower bounds for any implementation of the call, not of the
program's: the genotypes' information at 2 bits an entry read once, the
(R, 1 + 4P) float64 result written once, and 2·R·N·(k + P) operations, the
products of every entry with the covariates and phenotypes. So a program
that fuses its kernels or computes with fewer digit planes cannot push a
share of this bound over 1.
"""

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12


def call_bytes(R: int, N: int, P: int) -> float:
    return R * N / 4 + R * (1 + 4 * P) * 8


def call_ops(R: int, N: int, k: int, P: int) -> float:
    return 2.0 * R * N * (k + P)


def least_time_s(R: int, N: int, k: int, P: int) -> float:
    return max(call_bytes(R, N, P) / HBM_BYTES_PER_S,
               call_ops(R, N, k, P) / INT8_OPS_PER_S)
