"""The benchmark of hail_tpu_torch on NVIDIA cards.

    python3 -m gwasbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of `BENCHMARK.json` once: it makes the cell's inputs from the
seed, warms the program up, calls the configuration's method of
`hail_tpu_torch` (`linear_regression_rows` so far) in a closed loop for
`--seconds`, checks a seeded sample of what the window produced against the
method's plain NumPy reference in `gwasbench/reference/`, and prints one
JSON line. Everything that belongs to one configuration, one traffic mix,
one method, one genotype mode, one metric or one cell's limits is a file of
its own, found by its name: `configs/<config>.json`,
`traffic/<traffic>.json`, `methods/<method>.py`, `genotypes/<mode>.py`,
`metrics/<metric>.py`, `limits/<cell>.json` (`run.py` says what each
provides).
"""
