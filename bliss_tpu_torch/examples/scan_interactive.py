"""Interactive library scan: live progress + cancellation, over the port.

The terminal analog of the reference's GTK scanner
(reference: python/examples/analyze_gui.py — a worker thread with a
progress bar and a cancel button backed by a threading.Event): analysis
streams in the background while the foreground waits for a single 'q'
keypress (or Ctrl-C) to cancel. Cancellation drains the in-flight device
batches, flushes the feature store, and the next run resumes from it.

Usage: python -m bliss_tpu_torch.examples.scan_interactive [--device cuda|cpu] <music-dir> [store-dir]
"""

from __future__ import annotations

import argparse
import sys
import threading

from bliss_tpu_torch.cli import _collect_audio_files
from bliss_tpu_torch.pipeline import analyze_library
from bliss_tpu_torch.store import FeatureStore
from bliss_tpu_torch.tools import add_device_arg, device_arg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bliss_tpu_torch.examples.scan_interactive",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("music_dir")
    ap.add_argument("store_dir", nargs="?", default=".bliss-store")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_arg(args.device, "scan_interactive")
    files = _collect_audio_files([args.music_dir])
    store = FeatureStore(args.store_dir)
    cancel = threading.Event()

    def keywatcher():
        # one-char reads; 'q' cancels (the GUI's cancel button)
        try:
            import termios
            import tty

            fd = sys.stdin.fileno()
            old = termios.tcgetattr(fd)
            try:
                tty.setcbreak(fd)
                while not cancel.is_set():
                    if sys.stdin.read(1).lower() == "q":
                        cancel.set()
                        return
            finally:
                termios.tcsetattr(fd, termios.TCSADRAIN, old)
        except Exception:  # non-tty stdin: rely on Ctrl-C
            pass

    watcher = threading.Thread(target=keywatcher, daemon=True)
    watcher.start()

    def progress(done, total, msg):
        pct = 100.0 * done / max(total, 1)
        bar = "#" * int(pct / 2.5)
        print(f"\r[{bar:40s}] {pct:5.1f}%  {msg[:50]:50s} (q to cancel)",
              end="", file=sys.stderr)

    result = analyze_library(
        files, store=store, batch_size=16, progress=progress, cancel=cancel, device=device
    )
    print("", file=sys.stderr)
    n_ok = int(result.ok.sum())
    if result.stats.get("cancelled"):
        print(f"cancelled: {n_ok}/{len(files)} analyzed and stored — rerun "
              "to resume")
        return 130
    print(f"done: {n_ok}/{len(files)} songs analyzed "
          f"({len(result.errors)} failed)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
