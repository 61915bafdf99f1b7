"""The port's benchmark suite, the counterpart of the repo's ``benchmarks/``
and ``bench.py``: ``run_benchmarks`` (train throughput of the nine model
configurations, the matchers, the panoptic model and the pre-trainer; the
CLI's ``benchmark`` command), ``profile_step`` (device time of the
flagship step by kernel category, activation resolution and component)
and ``roofline`` (each component's operations and bytes against the
H100's peaks). The root's ``bench_torch.py`` is ``bench.py`` for the
port. Every measuring entry point runs on the card and raises without one
unless the caller passes ``device="cpu"``."""
