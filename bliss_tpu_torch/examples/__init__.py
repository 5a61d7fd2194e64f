"""The examples of ``examples/`` over the port, each run as
``python -m bliss_tpu_torch.examples.<name> [--device cuda|cpu] ...``:
``song_api_demo``, ``distance_demo``, ``library_scan``, ``make_playlist``,
``scan_interactive`` and ``analyze_gui``. Each prints what its counterpart
prints, on ``--device`` (default ``cuda``, or ``BLISS_TPU_TORCH_DEVICE``);
without a GPU each stops with ``resolve_device``'s error unless it is
given ``--device cpu``."""
