"""The benchmark of ``sentinel_tpu_torch`` (see ``run.py``)."""
