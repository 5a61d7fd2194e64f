"""User-facing tools over the port, each run as
``python -m bliss_tpu_torch.tools.<name>``:

- ``quality_benchmark``: do the 45 extended columns make better playlists
  than the core 4 on song families that collide in core space?
- ``gen_library``: a synthetic FLAC library, written fast from pooled
  frames;
- ``bench_similarity``: the full-library k-NN of ``store neighbors`` and
  ``store dupes``, timed;
- ``demo_scale``: a 10k x 10k distance matrix and top-100, a 100k-song
  k-means and a library scan, timed.

Every tool that touches a device takes ``--device`` (default ``cuda``, or
``BLISS_TPU_TORCH_DEVICE`` as the CLI reads it): without a GPU it stops with
``resolve_device``'s error unless it is given ``--device cpu``.
"""

from __future__ import annotations

import os

import torch

from bliss_tpu_torch.features.types import resolve_device


def add_device_arg(parser) -> None:
    """``--device`` of the port's CLI, tools and examples."""
    parser.add_argument(
        "--device",
        default=os.environ.get("BLISS_TPU_TORCH_DEVICE", "cuda"),
        help="torch device the analysis and similarity run on ('cuda',"
        " 'cuda:1', 'cpu'); without a GPU, 'cuda' fails rather than running"
        " on the CPU (env fallback: BLISS_TPU_TORCH_DEVICE)",
    )


def device_arg(device, prog: str) -> torch.device:
    """``device`` resolved; without the GPU it asks for, ``prog`` stops with
    ``resolve_device``'s error."""
    try:
        return resolve_device(device)
    except RuntimeError as e:
        raise SystemExit(f"{prog}: {e}") from None


def sync(device) -> None:
    """Wait for ``device``'s queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def card_line() -> str | None:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them, or None where
    there is no ``nvidia-smi``."""
    import shutil
    import subprocess

    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None
