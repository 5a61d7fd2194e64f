"""The stage breakdown of the sample-statistics kernel on the card: the
library behind ``python -m bliss_tpu_torch.ablate`` (see ``__main__``).

``inputs(shape)`` makes the TPU scripts' data at ``SHAPES[shape]`` on the
card; ``cases(inputs)`` lists every variant of A1, A2 and A3 (and the
shipped K2) with its call, plain version and work; ``run(shape)`` times
each with ``device_ms`` and logs one line per variant.
"""

from __future__ import annotations

import statistics
import subprocess

import torch

from bliss_tpu_torch.ablate import dma, fused, matred, packread
from bliss_tpu_torch.ablate import probe as _probe
from bliss_tpu_torch.kernels import bounds
from bliss_tpu_torch.kernels import fused_stats as fs

SHAPES = {"main": (64, 1 << 23, 1 << 18), "script": (128, 491520, 245760)}
SEED = 0
TARGET_MS = 50.0  # device time of one timed run of launches


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def inputs(shape: str, device="cuda") -> dict:
    """The scripts' data at ``shape``, made on ``device``: int16 x, its
    int32 and float32 copies and packed int32 words, alpha and beta."""
    B, L, chunk = SHAPES[shape]
    gen = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randint(-3000, 3000, (B, L), dtype=torch.int16, device=device, generator=gen)
    return {
        "B": B, "L": L, "chunk": chunk, "x": x,
        "x32": x.to(torch.int32), "xf": x.to(torch.float32),
        "words": packread.packed_words(x),
        "alpha": torch.full((B,), 1e-3, dtype=torch.float32, device=device),
        "beta": torch.full((B,), 1e-5, dtype=torch.float32, device=device),
    }


def cases(inp: dict) -> list[dict]:
    """Every variant at ``inp``'s shape: its name, kernel (A1, A2, A3, or
    K2 for the shipped stats kernel), the wrapper's call, its plain version
    (None for K2, which chip_smoke.py holds to its own), its work for
    ``kernels/bounds.py``, the input bytes it reads, for the probes
    ``scale``: each output's sum of |term| + 1, the scale of its rounding,
    and ``timed``, the call that ``run`` times: the wrapper's, except for
    A1, whose launch is timed without the copy into the script's layout."""
    B, L, chunk = inp["B"], inp["L"], inp["chunk"]
    x, a, b = inp["x"], inp["alpha"], inp["beta"]
    out = []

    def case(name, kernel, call, plain, work, read, scale=None, timed=None):
        out.append({"name": name, "kernel": kernel, "call": call, "plain": plain,
                    "work": work, "read": read, "scale": scale, "timed": timed or call})

    for v, (_, cheb, conv, warm, dtype) in fused.VARIANTS.items():
        case(f"stats {v}", "A1",
             lambda v=v: fused.stats_variant(x, a, b, v, chunk=chunk),
             lambda v=v: fused.stats_variant_reference(x, a, b, v, chunk=chunk),
             bounds.stats_work(B, L, cheb=cheb, conv=conv, warm=warm,
                               fir_bytes=dtype.itemsize),
             2 * B * L, timed=lambda v=v: fused.stats_pieces(x, a, b, v))
    case("stats shipped fused_stats_call", "K2", lambda: fs.fused_stats_call(x, a, b), None,
         bounds.stats_work(B, L), 2 * B * L)

    def probe_case(name, fn, plain_fn, t, mode, chunk_elems):
        rows, nblk = _probe.rows(t, chunk_elems)
        work = bounds.probe_work(mode, B, rows.shape[1], nblk, t.element_size())
        read = work["bytes"] - 4 * B * rows.shape[1] * 8
        scale = lambda: _probe.probe_reference(rows, nblk, mode, absolute=True).double() + 1.0
        case(name, "A2", lambda: fn(t, chunk=chunk), lambda: plain_fn(t, chunk=chunk),
             work, read, scale)

    for body, mode in fused.BODIES.items():
        probe_case(f"S1b {body}",
                   lambda t, chunk, body=body: fused.reduce_probe(t, body, chunk=chunk),
                   lambda t, chunk, body=body: fused.reduce_probe_reference(t, body, chunk=chunk),
                   x, mode, chunk)
    probe_case("S2 noin", dma.call_noin, dma.call_noin_reference, x, "zero", chunk)
    for key, label in (("x", "i16"), ("x32", "i32"), ("xf", "f32")):
        probe_case(f"S2 x {label}", dma.call_x, dma.call_x_reference, inp[key], "slice", chunk)
        probe_case(f"S2 touch {label}", dma.call_touch, dma.call_touch_reference, inp[key],
                   "sum1", chunk)
    w = inp["words"]
    probe_case("S3 i16", packread.call_i16, packread.call_i16_reference, x, "sum1", chunk)
    probe_case("S3 packed", packread.call_packed, packread.call_packed_reference, w,
               "packed", chunk // 2)
    probe_case("S3 packed_nounpack", packread.call_packed_nounpack,
               packread.call_packed_nounpack_reference, w, "sum1", chunk // 2)
    for deg, hw in ((18, 200), (14, 128)):
        case(f"S4 matred cheb{deg}/{hw}", "A3",
             lambda deg=deg, hw=hw: matred.proto_call(x, a, b, deg, hw, chunk=chunk),
             lambda deg=deg, hw=hw: matred.matred_reference(x, a, b, deg, hw, chunk=chunk),
             bounds.matred_work(B, L, ncheb=deg + 1), 2 * B * L)
    return out


def device_ms(fn, reps: int = 5) -> float:
    """ms a launch: CUDA events around a run of launches sized to
    ~TARGET_MS after a warm-up, divided by the count; median of ``reps``
    runs."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    n = int(min(100, max(3, TARGET_MS / max(a.elapsed_time(b), 1e-3))))
    times = []
    for _ in range(reps):
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def run(shape: str, *, log=print) -> list[dict]:
    """Times every case at ``shape`` on the current CUDA device, logs one
    line each and returns them as dicts."""
    if not torch.cuda.is_available():
        raise RuntimeError("the ablation times kernels on an NVIDIA GPU; none found")
    card = card_line()
    inp = inputs(shape)
    B, L = inp["B"], inp["L"]
    rows = []
    for c in cases(inp):
        name, kernel, read = c["name"], c["kernel"], c["read"]
        ms = device_ms(c["timed"])
        bound, by = bounds.bound_ms(c["work"])
        row = {"shape": shape, "name": name, "kernel": kernel, "ms": ms,
               "bound_ms": bound, "bound_by": by, "read_gbps": read / ms / 1e6}
        rows.append(row)
        rate = ""
        if kernel == "A2":
            rate = (f"  read {read / 1e9:.3f} GB at {row['read_gbps']:.1f} GB/s = "
                    f"{row['read_gbps'] / bounds.PEAK['bytes'] * 1e9:.1%} of 3.35 TB/s")
        log(f"ablate {shape} B={B} L={L} {name:32s} {ms:9.4f} ms  bound {bound:.4f} ms "
            f"({by}){rate}  [{card}]")
    return rows
