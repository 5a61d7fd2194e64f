"""Library scanner GUI: background-thread batch analysis to CSV (a copy of
``bliss_tpu/gui.py`` over the port's pipeline, on ``device``).

Rebuild of the reference's GTK scanner (reference:
python/examples/analyze_gui.py:13-58 — a worker thread writing one
'|'-delimited CSV row per song, a progress bar, and cancellation backed
by a threading.Event). Same contract, different engine: analysis runs
through the batched device pipeline
(bliss_tpu_torch.pipeline.analyze_library, on the GPU unless the caller
asks for the CPU)
instead of one bl_song at a time, so the worker reports pipeline progress
and writes the CSV once results finalize; cancellation drains the
in-flight device batches, so a cancelled scan still yields a valid
partial CSV (the reference gets the same property from its row-per-song
flush).

All scan logic lives in ScanJob, which is headless-testable
(tests/test_torch_gui.py) — the tkinter view is a thin shell over it.
Launch with ``bliss-tpu-torch gui`` (or ``python -m bliss_tpu_torch.gui``;
``bliss-tpu-torch scan`` is the terminal equivalent).
"""

from __future__ import annotations

import csv
import os
import sys
import threading

CSV_DIALECT = dict(delimiter="|", quotechar="'", quoting=csv.QUOTE_MINIMAL)


def discover_audio_files(root: str, recursive: bool = False) -> list[str]:
    """Audio files under ``root``, sorted for determinism
    (reference: python/examples/analyze_gui.py:14-24). The mimetype filter
    is the CLI's, so GUI and CLI scans always agree on what counts as
    audio."""
    from bliss_tpu_torch.cli import is_audio_filename  # deferred: cli imports gui

    root = os.path.expanduser(root)
    if recursive:
        cands = [
            os.path.join(dp, f)
            for dp, _dn, fn in os.walk(root)
            for f in sorted(fn)
        ]
    else:
        try:
            cands = [os.path.join(root, f) for f in sorted(os.listdir(root))]
        except OSError:
            return []
    return [f for f in cands if os.path.isfile(f) and is_audio_filename(f)]


class ScanJob:
    """One background library scan: discover -> batched analyze -> CSV, on
    ``device`` (the GPU unless the caller asks for the CPU).

    Callbacks fire on the WORKER thread; views marshal them to their main
    loop (the tkinter shell below uses a queue + ``after`` polling).
    """

    def __init__(
        self,
        library_dir: str,
        csv_path: str,
        *,
        recursive: bool = False,
        batch_size: int = 16,
        device="cuda",
        on_progress=None,  # (done, total, message)
        on_done=None,  # (n_rows_written, cancelled)
        on_error=None,  # (message)
    ):
        self.library_dir = library_dir
        self.csv_path = csv_path
        self.recursive = recursive
        self.batch_size = batch_size
        self.device = device
        self.cancel_event = threading.Event()
        self.on_progress = on_progress or (lambda done, total, msg: None)
        self.on_done = on_done or (lambda rows, cancelled: None)
        self.on_error = on_error or (lambda msg: None)
        self._thread: threading.Thread | None = None

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()

    def cancel(self) -> None:
        self.cancel_event.set()

    def join(self, timeout: float | None = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- the actual work (callable synchronously in tests) ---------------
    def run(self) -> int:
        try:
            return self._run()
        except Exception as e:  # worker thread: an unreported exception
            # would leave the view stuck on "scanning…" forever
            self.on_error(f"scan failed: {e}")
            return 0

    def _run(self) -> int:
        files = discover_audio_files(self.library_dir, self.recursive)
        if not files:
            # same user-facing message as the reference (analyze_gui.py:27)
            self.on_error("Please enter a valid directory containing audio files")
            return 0
        from bliss_tpu_torch.pipeline import analyze_library

        result = analyze_library(
            files,
            batch_size=self.batch_size,
            device=self.device,
            progress=self.on_progress,
            cancel=self.cancel_event,
            handle_sigint=False,  # worker thread; the view owns signals
        )
        rows = self._write_csv(result)
        self.on_done(rows, self.cancel_event.is_set())
        return rows

    def _write_csv(self, result) -> int:
        """One row per successfully analyzed song, flushed as written —
        (filename, album, attack, tempo, amplitude, frequency), the
        reference's exact column order and dialect
        (analyze_gui.py:37-49). Failed songs are skipped, like its
        ``duration > 0`` check."""
        from bliss_tpu_torch.io.decoder import probe

        n = 0
        with open(self.csv_path, "w", newline="") as fh:
            writer = csv.writer(fh, **CSV_DIALECT)
            for i, fname in enumerate(result.files):
                if not result.ok[i]:
                    continue
                try:
                    album = probe(fname).album
                except Exception:
                    album = None
                tempo, amplitude, frequency, attack = (
                    float(result.features[i, j]) for j in range(4)
                )
                writer.writerow(
                    (fname, album or "", attack, tempo, amplitude, frequency)
                )
                fh.flush()
                n += 1
        return n


# -- tkinter shell (needs a display; everything above does not) ----------


def build_app(device="cuda"):
    import queue
    import tkinter as tk
    from tkinter import filedialog, ttk

    root = tk.Tk()
    root.title("bliss-tpu-torch data generator")
    events: queue.Queue = queue.Queue()
    state = {"job": None, "lib": "", "csv": os.path.join(os.getcwd(), "output.csv")}

    frame = ttk.Frame(root, padding=8)
    frame.grid(sticky="nsew")
    root.columnconfigure(0, weight=1)
    frame.columnconfigure(1, weight=1)

    lib_label = ttk.Label(frame, text="(no library selected)")
    csv_label = ttk.Label(frame, text=state["csv"])
    recursive_var = tk.BooleanVar(value=False)
    bar = ttk.Progressbar(frame, maximum=1.0, mode="determinate")
    status = ttk.Label(frame, text="")

    def pick_lib():
        d = filedialog.askdirectory(title="Please choose a folder to analyze")
        if d:
            state["lib"] = d
            lib_label.config(text=d)

    def pick_csv():
        f = filedialog.asksaveasfilename(
            title="Please choose an output CSV file",
            defaultextension=".csv",
            initialfile=os.path.basename(state["csv"]),
        )
        if f:
            state["csv"] = f
            csv_label.config(text=f)

    def go():
        job = state["job"]
        if job is not None and job.running:  # acting as the Cancel button
            job.cancel()
            return
        if not (os.path.isabs(state["lib"]) and os.path.isabs(state["csv"])):
            status.config(text="Please enter a valid directory containing audio files")
            return
        job = ScanJob(
            state["lib"],
            state["csv"],
            recursive=recursive_var.get(),
            device=device,
            on_progress=lambda d, t, m: events.put(("progress", d, t, m)),
            on_done=lambda rows, cancelled: events.put(("done", rows, cancelled)),
            on_error=lambda msg: events.put(("error", msg)),
        )
        state["job"] = job
        go_btn.config(text="Cancel")
        status.config(text="scanning…")
        job.start()

    def poll():
        try:
            while True:
                ev = events.get_nowait()
                if ev[0] == "progress":
                    _, done, total, msg = ev
                    bar["value"] = done / max(total, 1)
                    status.config(text=msg[:70])
                elif ev[0] == "done":
                    _, rows, cancelled = ev
                    go_btn.config(text="Go")
                    status.config(
                        text=f"{'Cancelled — ' if cancelled else ''}Done! "
                        f"{rows} songs -> {state['csv']}"
                    )
                else:
                    go_btn.config(text="Go")
                    status.config(text=ev[1])
        except queue.Empty:
            pass
        root.after(100, poll)

    ttk.Button(frame, text="Open…", command=pick_lib).grid(row=0, column=0, sticky="w")
    lib_label.grid(row=0, column=1, sticky="ew", padx=6)
    ttk.Button(frame, text="Save as CSV…", command=pick_csv).grid(
        row=1, column=0, sticky="w"
    )
    csv_label.grid(row=1, column=1, sticky="ew", padx=6)
    ttk.Checkbutton(frame, text="Recursive scan", variable=recursive_var).grid(
        row=2, column=0, columnspan=2, sticky="w"
    )
    bar.grid(row=3, column=0, columnspan=2, sticky="ew", pady=4)
    status.grid(row=4, column=0, columnspan=2, sticky="w")
    go_btn = ttk.Button(frame, text="Go", command=go)
    go_btn.grid(row=5, column=1, sticky="e")
    ttk.Button(frame, text="Quit", command=root.destroy).grid(
        row=5, column=0, sticky="w"
    )
    root.after(100, poll)
    return root


def main(device="cuda") -> int:
    try:
        app = build_app(device)
    except Exception as e:  # no $DISPLAY etc.
        print(f"Cannot open a display ({e}).", file=sys.stderr)
        print(
            "Use the terminal scanner instead: bliss-tpu-torch scan <dir> -o out.csv",
            file=sys.stderr,
        )
        return 1
    app.mainloop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
