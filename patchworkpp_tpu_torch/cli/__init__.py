"""Command-line entry points of the PyTorch port (``python3 -m
patchworkpp_tpu_torch.cli.<name>``). Each runs on CUDA unless given
``--device cpu``, and reads the six-scan workload of :mod:`.workload`.

- :mod:`bench` — the port's throughput benchmark, one JSON line
- :mod:`stream_bench` — per-frame streaming throughput (numpy or native loader)
- :mod:`serve_bench` — the streaming server's latency, closed loop and overload
- :mod:`soak` — a long state-chained run with state and FIFO audits
- :mod:`demo_sequential` — adapted-state demo through the compat module
- :mod:`demo_multi_stream` — two streams through one engine
- :mod:`demo_visualize` — one scan: summary, headless PNG or Open3D window
- :mod:`eval_semantickitti` — P/R/F1 against SemanticKITTI labels or a golden npz
"""
