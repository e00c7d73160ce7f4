"""The benchmark of box2d_mt_tpu_torch on one card: `python3 benchmark/run.py`."""
