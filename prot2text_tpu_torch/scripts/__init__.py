"""The port's probe scripts: microbenchmarks of the quantized-matmul and
int8-KV kernels K15a-K15l beside the shipped K10, K11a and K14, each the
counterpart of a TPU probe under `scripts/` with the same name.

    python -m prot2text_tpu_torch.scripts.<name> [--device cuda|cpu] [--reps N]

On the card each prints one row per variant (device ms per call from CUDA
graphs, GB/s or TOP/s, the share of the call's bound, the eager time with
its host cost) and a row for the library yardstick; `main()` returns the
rows.  `--device cpu` runs the plain versions and reports host time only.
"""
