// bliss C compatibility library of the PyTorch port (bliss_tpu_torch).
//
// Implements include/bliss.h, the reference's public C surface, over the
// port; the counterpart of bliss_tpu/compat/compat_shim.cc:
//   - decode (bl_audio_decode, and the decode step of bl_analyze and the
//     *_file calls): bliss_tpu_torch.io.decoder.decode, called in the
//     embedded interpreter. The library links no decoder of its own and is
//     compiled with BLISS_COMPAT_NO_LIBAV, so it builds where libav's
//     development files are missing; there decode fails with the decoder's
//     own message, and a caller that fills sample_array itself still gets
//     every analysis call.
//   - analysis (bl_analyze, bl_amplitude_sort, bl_frequency_sort,
//     bl_envelope_sort): the port's analyzers through a CPython interpreter
//     started at first use (or the caller's own, when the library is loaded
//     into a Python process). Each call reads two variables:
//     BLISS_TPU_TORCH_COMPAT_MODE, "parity" (the default:
//     AnalysisConfig.for_parity(), float64, within the reference's own test
//     epsilon) or "gpu" (AnalysisConfig.for_gpu(), the main path: the
//     prepass, then K1); and BLISS_TPU_TORCH_DEVICE, the torch device
//     ("cuda" unless set). Without a GPU a call on "cuda" fails with
//     BL_UNEXPECTED and the reason on stderr; it never runs on the CPU unless
//     the variable says "cpu".
//   - distance/cosine and the helpers: plain C++, the JAX shim's arithmetic.
//
// Build-time defines (compat/__init__.py::library_path passes them):
// BLISS_TORCH_ROOT, the checkout that holds bliss_tpu_torch (a moved
// checkout builds its own library: the root is part of the build's hash);
// BLISS_TORCH_PYPATH, the building interpreter's site directories and the
// one its torch comes from, joined by ':', which a program that embeds the
// interpreter would not find from its own location (a venv's); and
// BLISS_TORCH_TORCH, the directory of the torch package that interpreter
// imports: the bootstrap refuses to run against any other.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include "include/bliss.h"

#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>

#ifndef BLISS_TORCH_ROOT
#define BLISS_TORCH_ROOT ""
#endif
#ifndef BLISS_TORCH_PYPATH
#define BLISS_TORCH_PYPATH ""
#endif
#ifndef BLISS_TORCH_TORCH
#define BLISS_TORCH_TORCH ""
#endif

namespace {

char *dup_cstr(const char *s) {
  if (!s) return nullptr;
  char *out = static_cast<char *>(malloc(strlen(s) + 1));
  strcpy(out, s);
  return out;
}

// ---- embedded interpreter ---------------------------------------------------

std::once_flag g_py_once;
PyObject *g_helpers = nullptr;  // the bootstrap's namespace; null if it failed

const char *kBootstrap = R"PY(
import os, site, sys
_new = [p for p in [_BUILT_ROOT] + _BUILT_PATH.split(os.pathsep) if p and p not in sys.path]
sys.path[:0] = _new
for _p in _new:
    if os.path.isdir(_p):
        site.addsitedir(_p)  # the .pth files of a site directory
import torch
_torch = os.path.dirname(os.path.realpath(torch.__file__))
if _BUILT_TORCH and _torch != _BUILT_TORCH:
    raise ImportError(
        f"libbliss.so was built against the torch in {_BUILT_TORCH}, but this "
        f"interpreter imports the one in {_torch}: build the library from the "
        "interpreter that runs it")
import numpy as np
from bliss_tpu_torch.api import analyze_features
from bliss_tpu_torch.config import AnalysisConfig
from bliss_tpu_torch.features.amplitude import amplitude_scores
from bliss_tpu_torch.features.frequency import frequency_scores
from bliss_tpu_torch.features.tempo import envelope_scores
from bliss_tpu_torch.features.types import PCMBatch, resolve_device
from bliss_tpu_torch.io import decoder

_CONFIGS = {'parity': AnalysisConfig.for_parity(), 'gpu': AnalysisConfig.for_gpu()}

def _cfg():
    mode = os.environ.get('BLISS_TPU_TORCH_COMPAT_MODE') or 'parity'
    if mode not in _CONFIGS:
        raise ValueError(f"BLISS_TPU_TORCH_COMPAT_MODE={mode!r}: use 'parity' or 'gpu'")
    return _CONFIGS[mode]

def _batch(mem, n, duration, cfg):
    pcm = np.frombuffer(mem, dtype=np.int16, count=n)
    device = resolve_device(os.environ.get('BLISS_TPU_TORCH_DEVICE') or 'cuda')
    return PCMBatch.from_arrays([pcm], [max(int(duration), 1)],
                                pad_multiple=cfg.pad_multiple, device=device)

def analyze(mem, n, duration):
    cfg = _cfg()
    return tuple(float(x) for x in analyze_features(_batch(mem, n, duration, cfg), cfg)[0])

def amplitude(mem, n):
    cfg = _cfg()
    return float(amplitude_scores(_batch(mem, n, 1, cfg), cfg)[0])

def frequency(mem, n):
    cfg = _cfg()
    return float(frequency_scores(_batch(mem, n, 1, cfg), cfg)[0])

def envelope(mem, n, duration):
    cfg = _cfg()
    t, a = envelope_scores(_batch(mem, n, duration, cfg), cfg)
    return float(t[0]), float(a[0])

def decode(path):
    d = decoder.decode(path)
    tags = (d.artist, d.title, d.album, d.tracknumber, d.genre)
    return (np.ascontiguousarray(d.samples, dtype=np.int16).tobytes(), d.channels,
            d.sample_rate, d.bitrate, d.nb_bytes_per_sample, d.resampled, d.duration,
            *(t or None for t in tags))
)PY";

// Holds the GIL for the life of the object, on any thread.
struct Gil {
  PyGILState_STATE state;
  Gil() : state(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(state); }
};

// Prints the pending Python exception as one line and clears it; GIL held.
void report_error(const char *what) {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  const char *tname =
      type ? reinterpret_cast<PyTypeObject *>(type)->tp_name : "error";
  PyObject *text = value ? PyObject_Str(value) : nullptr;
  const char *msg = text ? PyUnicode_AsUTF8(text) : nullptr;
  if (!msg) PyErr_Clear();
  fprintf(stderr, "bliss_tpu_torch compat: %s: %s: %s\n", what, tname,
          msg ? msg : "(no message)");
  Py_XDECREF(text);
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

bool set_str(PyObject *ns, const char *key, const char *value) {
  PyObject *s = PyUnicode_FromString(value);
  bool ok = s && PyDict_SetItemString(ns, key, s) == 0;
  Py_XDECREF(s);
  return ok;
}

void init_python() {
  std::call_once(g_py_once, [] {
    bool we_initialized = false;
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      we_initialized = true;
    }
    {
      Gil gil;
      PyObject *ns = PyDict_New();
      bool ok = ns &&
                PyDict_SetItemString(ns, "__builtins__",
                                     PyEval_GetBuiltins()) == 0 &&
                set_str(ns, "_BUILT_ROOT", BLISS_TORCH_ROOT) &&
                set_str(ns, "_BUILT_PATH", BLISS_TORCH_PYPATH) &&
                set_str(ns, "_BUILT_TORCH", BLISS_TORCH_TORCH);
      PyObject *res =
          ok ? PyRun_String(kBootstrap, Py_file_input, ns, ns) : nullptr;
      if (res) {
        g_helpers = ns;
      } else {
        report_error("starting the interpreter");
        Py_XDECREF(ns);
      }
      Py_XDECREF(res);
    }
    if (we_initialized) {
      // Py_InitializeEx left this thread holding the GIL, and the Gil
      // guard's release above was a no-op (the state was LOCKED). Without
      // dropping it here the first caller's thread keeps the GIL once it
      // returns to C, and every other thread's PyGILState_Ensure deadlocks:
      // a multithreaded C consumer hangs on its second thread. From here on
      // every access goes through balanced Ensure/Release pairs.
      PyEval_SaveThread();
    }
  });
}

// Starts the interpreter at first use; false, with a line on stderr, if it
// could not be started.
bool ready() {
  init_python();
  if (!g_helpers) {
    fprintf(stderr,
            "bliss_tpu_torch compat: the embedded interpreter did not start "
            "(see the first error)\n");
    return false;
  }
  return true;
}

bool has_samples(struct bl_song const *song) {
  if (song->sample_array && song->nSamples > 0) return true;
  fprintf(stderr, "bliss_tpu_torch compat: the song holds no samples\n");
  return false;
}

// Calls helper `name` on the song's PCM (and its duration); returns a new
// reference, or nullptr after printing the error. GIL held.
PyObject *call_on_song(const char *name, struct bl_song const *song,
                       bool with_duration) {
  PyObject *fn = PyDict_GetItemString(g_helpers, name);  // borrowed
  PyObject *mem = PyMemoryView_FromMemory(
      reinterpret_cast<char *>(song->sample_array),
      static_cast<Py_ssize_t>(song->nSamples) * 2, PyBUF_READ);
  PyObject *res = nullptr;
  if (fn && mem) {
    res = with_duration
              ? PyObject_CallFunction(fn, "OnK", mem,
                                      (Py_ssize_t)song->nSamples,
                                      (unsigned long long)song->duration)
              : PyObject_CallFunction(fn, "On", mem,
                                      (Py_ssize_t)song->nSamples);
  }
  Py_XDECREF(mem);
  if (!res) report_error(name);
  return res;
}

// One float result of helper `name`, or BL_UNEXPECTED.
float score(const char *name, struct bl_song const *song) {
  if (!has_samples(song) || !ready()) return BL_UNEXPECTED;
  Gil gil;
  PyObject *res = call_on_song(name, song, false);
  if (!res) return BL_UNEXPECTED;
  double v = PyFloat_AsDouble(res);
  Py_DECREF(res);
  if (v == -1.0 && PyErr_Occurred()) {
    report_error(name);
    return BL_UNEXPECTED;
  }
  return (float)v;
}

float vec_distance(struct force_vector_s a, struct force_vector_s b) {
  double dt = a.tempo - b.tempo;
  double da = a.amplitude - b.amplitude;
  double df = a.frequency - b.frequency;
  double dk = a.attack - b.attack;
  return (float)sqrt(dt * dt + da * da + df * df + dk * dk);
}

float vec_cosine(struct force_vector_s a, struct force_vector_s b) {
  double num = a.tempo * b.tempo + a.amplitude * b.amplitude +
               a.frequency * b.frequency + a.attack * b.attack;
  double na = sqrt(a.tempo * a.tempo + a.amplitude * a.amplitude +
                   a.frequency * a.frequency + a.attack * a.attack);
  double nb = sqrt(b.tempo * b.tempo + b.amplitude * b.amplitude +
                   b.frequency * b.frequency + b.attack * b.attack);
  return (float)(num / (na * nb));
}

}  // namespace

extern "C" {

void bl_initialize_song(struct bl_song *const song) {
  song->artist = nullptr;
  song->title = nullptr;
  song->album = nullptr;
  song->tracknumber = nullptr;
  song->sample_array = nullptr;
  song->filename = nullptr;
  song->genre = nullptr;
}

void bl_free_song(struct bl_song *const song) {
  free(song->artist);
  free(song->title);
  free(song->album);
  free(song->tracknumber);
  free(song->sample_array);
  free(song->filename);
  free(song->genre);
  bl_initialize_song(song);
}

int bl_audio_decode(char const *const filename, struct bl_song *const song) {
  if (!ready()) return BL_UNEXPECTED;
  Gil gil;
  PyObject *fn = PyDict_GetItemString(g_helpers, "decode");  // borrowed
  PyObject *res = fn ? PyObject_CallFunction(fn, "s", filename) : nullptr;
  const char *buf = nullptr;
  Py_ssize_t len = 0;
  int channels, sample_rate, bitrate, nb_bytes, resampled;
  unsigned long long duration;
  const char *tags[5] = {nullptr, nullptr, nullptr, nullptr, nullptr};
  if (!res || !PyArg_ParseTuple(res, "y#iiiiiKzzzzz", &buf, &len, &channels,
                                &sample_rate, &bitrate, &nb_bytes, &resampled,
                                &duration, &tags[0], &tags[1], &tags[2],
                                &tags[3], &tags[4])) {
    report_error(filename);
    Py_XDECREF(res);
    return BL_UNEXPECTED;
  }
  if (len / 2 > INT_MAX) {
    fprintf(stderr, "bliss_tpu_torch compat: %s: too many samples for int\n",
            filename);
    Py_DECREF(res);
    return BL_UNEXPECTED;
  }
  song->sample_array = static_cast<int8_t *>(malloc((size_t)len));
  memcpy(song->sample_array, buf, (size_t)len);
  song->nSamples = (int)(len / 2);
  song->channels = channels;
  song->sample_rate = sample_rate;
  song->bitrate = bitrate;
  song->nb_bytes_per_sample = nb_bytes;
  song->resampled = resampled;
  song->duration = duration;
  song->filename = dup_cstr(filename);
  song->artist = dup_cstr(tags[0]);
  song->title = dup_cstr(tags[1]);
  song->album = dup_cstr(tags[2]);
  song->tracknumber = dup_cstr(tags[3]);
  song->genre = dup_cstr(tags[4]);
  Py_DECREF(res);
  return BL_OK;
}

int bl_analyze(char const *const filename, struct bl_song *current_song) {
  if (bl_audio_decode(filename, current_song) != BL_OK) {
    fprintf(stderr, "Couldn't decode song\n");
    return BL_UNEXPECTED;
  }
  if (!has_samples(current_song)) return BL_UNEXPECTED;
  double v[4];
  {
    Gil gil;
    PyObject *res = call_on_song("analyze", current_song, true);
    if (!res) return BL_UNEXPECTED;
    bool ok = PyArg_ParseTuple(res, "dddd", &v[0], &v[1], &v[2], &v[3]);
    if (!ok) report_error("analyze");
    Py_DECREF(res);
    if (!ok) return BL_UNEXPECTED;
  }
  current_song->force_vector.tempo = (float)v[0];
  current_song->force_vector.amplitude = (float)v[1];
  current_song->force_vector.frequency = (float)v[2];
  current_song->force_vector.attack = (float)v[3];
  float rating = fmaxf(current_song->force_vector.tempo, 0.0f) +
                 current_song->force_vector.amplitude +
                 current_song->force_vector.frequency +
                 fmaxf(current_song->force_vector.attack, 0.0f);
  current_song->force = rating;
  current_song->calm_or_loud =
      rating > 0 ? BL_LOUD : (rating < 0 ? BL_CALM : BL_UNKNOWN);
  return current_song->calm_or_loud;
}

float bl_amplitude_sort(struct bl_song const *const song) {
  return score("amplitude", song);
}

float bl_frequency_sort(struct bl_song const *const song) {
  return score("frequency", song);
}

void bl_envelope_sort(struct bl_song const *const song,
                      struct envelope_result_s *result) {
  result->tempo = result->attack = BL_UNEXPECTED;
  if (!has_samples(song) || !ready()) return;
  Gil gil;
  PyObject *res = call_on_song("envelope", song, true);
  if (!res) return;
  double t, a;
  if (PyArg_ParseTuple(res, "dd", &t, &a)) {
    result->tempo = (float)t;
    result->attack = (float)a;
  } else {
    report_error("envelope");
  }
  Py_DECREF(res);
}

float bl_distance(struct force_vector_s v1, struct force_vector_s v2) {
  return vec_distance(v1, v2);
}

float bl_cosine_similarity(struct force_vector_s v1,
                           struct force_vector_s v2) {
  return vec_cosine(v1, v2);
}

float bl_distance_file(char const *const f1, char const *const f2,
                       struct bl_song *s1, struct bl_song *s2) {
  if (bl_analyze(f1, s1) == BL_UNEXPECTED ||
      bl_analyze(f2, s2) == BL_UNEXPECTED)
    return BL_UNEXPECTED;
  return vec_distance(s1->force_vector, s2->force_vector);
}

float bl_cosine_similarity_file(char const *const f1, char const *const f2,
                                struct bl_song *s1, struct bl_song *s2) {
  if (bl_analyze(f1, s1) == BL_UNEXPECTED ||
      bl_analyze(f2, s2) == BL_UNEXPECTED)
    return BL_UNEXPECTED;
  return vec_cosine(s1->force_vector, s2->force_vector);
}

float bl_version(void) {
  printf("Using bliss analyzer version %0.1f.\n", BL_VERSION);
  return (float)BL_VERSION;
}

int bl_mean(int16_t *sample_array, int nSamples) {
  int acc = 0;
  for (int i = 0; i < nSamples; ++i) acc += sample_array[i];
  return acc / nSamples;
}

int bl_variance(int16_t *sample_array, int nSamples, int mean) {
  int64_t acc = 0;
  for (int i = 0; i < nSamples; ++i) {
    int32_t d = sample_array[i] - mean;
    acc += (int64_t)d * d;
  }
  return (int)(acc / nSamples);
}

void bl_rectangular_filter(double *out, double *in, int nSamples,
                           int smooth_width) {
  // Same semantics as the reference's running-mean filter, including the
  // edge slots (reference: src/tempo_atk_sort.c:19-40): interior slots get
  // centered box sums, slot n-half accumulates the tail sum, everything is
  // divided by the width.
  int half = (int)lround(smooth_width / 2.0);
  double acc = 0;
  for (int i = 0; i < smooth_width && i < nSamples; ++i) acc += in[i];
  for (int i = 0; i + smooth_width < nSamples + 1; ++i) {
    if (i + half - 1 < nSamples && i < nSamples - smooth_width)
      out[i + half - 1] = acc;
    if (i + smooth_width < nSamples) {
      acc -= in[i];
      acc += in[i + smooth_width];
    }
  }
  double tail = 0;
  for (int k = nSamples - smooth_width; k < nSamples; ++k)
    if (k >= 0) tail += in[k];
  if (nSamples - half >= 0) out[nSamples - half] += tail;
  for (int i = 0; i < nSamples; ++i) out[i] /= smooth_width;
}

}  // extern "C"
