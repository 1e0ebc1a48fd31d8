"""Command-line entry points of the PyTorch port (``python3 -m
patchworkpp_tpu_torch.cli.<name>``). Each runs on CUDA unless given
``--device cpu``, and reads the six-scan workload of :mod:`.workload`.

- :mod:`bench` — the port's throughput benchmark, one JSON line
- :mod:`stream_bench` — per-frame streaming throughput
- :mod:`serve_bench` — the streaming server's latency, closed loop and overload
- :mod:`soak` — a long state-chained run with state and FIFO audits
- :mod:`demo_sequential` — adapted-state demo through the compat module
- :mod:`demo_multi_stream` — two streams through one engine
"""
