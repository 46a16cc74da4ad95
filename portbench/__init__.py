"""The benchmark of halva_tpu_torch on the H100: `python3 -m portbench.run`."""
