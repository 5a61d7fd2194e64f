/* abi_check: a C consumer of the port's libbliss.so that calls all fifteen
 * functions of bliss.h and prints one parseable line a result.
 *
 *   abi_check [--threads T --rounds R] [--raw PCM.s16 DURATION]...
 *             [--bad FILE] [--rect IN.f64 OUT0.f64 WIDTH RESULT.f64] [FILE]...
 *
 * Build (compat/__init__.py::abi_check_path does this beside the library):
 *   gcc -O2 -pthread -DBLISS_COMPAT_NO_LIBAV -I<compat>/include abi_check.c \
 *       -L<dir of libbliss.so> -lbliss -Wl,-rpath,<that dir> -lm
 *
 * Each FILE is decoded by bl_audio_decode and analyzed by bl_analyze, each
 * --raw song is a caller-filled bl_song of raw interleaved int16 PCM at
 * 22050 Hz (no decode) given to the three sorts, bl_mean and bl_variance.
 * Lines, floats as %.9g (a float round-trips), the path last:
 *   version V
 *   cold_start SECONDS            (main's start to the end of the first
 *                                  analysis call: the interpreter's start)
 *   decode RC NSAMPLES CHANNELS SAMPLE_RATE BITRATE NB_BYTES RESAMPLED DURATION FILE
 *   tags ARTIST|TITLE|ALBUM|TRACKNUMBER|GENRE FILE
 *   analyze RC FORCE TEMPO AMPLITUDE FREQUENCY ATTACK CALM_OR_LOUD FILE
 *   sorts AMPLITUDE FREQUENCY TEMPO ATTACK PCM
 *   stats MEAN VARIANCE PCM
 *   distance I J DISTANCE COSINE  (every pair of the songs above, FILEs then
 *                                  raws, a raw song's vector from its sorts)
 *   distance_file DISTANCE COSINE (bl_distance_file and
 *                                  bl_cosine_similarity_file, the first two FILEs)
 *   bad DECODE_RC ANALYZE_RC DISTANCE_FILE COSINE_FILE FILE
 *   rect N WIDTH                  (bl_rectangular_filter of IN into a copy
 *                                  of OUT0, written to RESULT as float64)
 *   threads T ROUNDS ITEMS MISMATCHES
 * With --threads, T pthreads then run every FILE's bl_analyze and every raw
 * song's sorts R times each at once, and each result must equal the
 * single-thread one bit for bit. Exit status: 0, or 1 on a mismatch or a
 * file that cannot be read. */
#include "bliss.h"

#include <math.h>
#include <pthread.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#define MAX_SONGS 64

typedef struct {
  const char *path;
  int duration;
  struct bl_song song;
  float result[4]; /* tempo, amplitude, frequency, attack */
} item_t;

static item_t g_files[MAX_SONGS], g_raws[MAX_SONGS];
static int g_n_files, g_n_raws, g_rounds = 1;
static double g_t0;

static double now(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}

static void cold_start_line(void) {
  static int done;
  if (!done) printf("cold_start %.3f\n", now() - g_t0);
  done = 1;
}

static void *read_all(const char *path, long *n_bytes) {
  FILE *f = fopen(path, "rb");
  if (!f) return NULL;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  void *buf = malloc(n > 0 ? n : 1);
  if (fread(buf, 1, n, f) != (size_t)n) {
    free(buf);
    buf = NULL;
  }
  fclose(f);
  *n_bytes = n;
  return buf;
}

static int analyze_file(const char *path, float out[4], int *rc,
                        struct bl_song *keep) {
  struct bl_song song;
  memset(&song, 0, sizeof song);
  *rc = bl_analyze(path, &song);
  out[0] = song.force_vector.tempo;
  out[1] = song.force_vector.amplitude;
  out[2] = song.force_vector.frequency;
  out[3] = song.force_vector.attack;
  if (keep) {
    *keep = song;
  } else {
    bl_free_song(&song);
  }
  return *rc != BL_UNEXPECTED;
}

static void sort_raw(const struct bl_song *song, float out[4]) {
  struct envelope_result_s env;
  out[1] = bl_amplitude_sort(song);
  out[2] = bl_frequency_sort(song);
  bl_envelope_sort(song, &env);
  out[0] = env.tempo;
  out[3] = env.attack;
}

static void *worker(void *arg) {
  long *mismatches = (long *)arg;
  for (int r = 0; r < g_rounds; ++r) {
    for (int i = 0; i < g_n_files; ++i) {
      float got[4];
      int rc;
      if (!analyze_file(g_files[i].path, got, &rc, NULL) ||
          memcmp(got, g_files[i].result, sizeof got) != 0)
        ++*mismatches;
    }
    for (int i = 0; i < g_n_raws; ++i) {
      float got[4];
      sort_raw(&g_raws[i].song, got);
      if (memcmp(got, g_raws[i].result, sizeof got) != 0) ++*mismatches;
    }
  }
  return NULL;
}

static const char *or_empty(const char *s) { return s ? s : ""; }

int main(int argc, char **argv) {
  g_t0 = now();
  int threads = 0, status = 0;
  const char *bad = NULL, *rect[4] = {NULL, NULL, NULL, NULL};
  for (int a = 1; a < argc; ++a) {
    if (!strcmp(argv[a], "--threads") && a + 1 < argc) {
      threads = atoi(argv[++a]);
    } else if (!strcmp(argv[a], "--rounds") && a + 1 < argc) {
      g_rounds = atoi(argv[++a]);
    } else if (!strcmp(argv[a], "--raw") && a + 2 < argc &&
               g_n_raws < MAX_SONGS) {
      g_raws[g_n_raws].path = argv[++a];
      g_raws[g_n_raws++].duration = atoi(argv[++a]);
    } else if (!strcmp(argv[a], "--bad") && a + 1 < argc) {
      bad = argv[++a];
    } else if (!strcmp(argv[a], "--rect") && a + 4 < argc) {
      for (int k = 0; k < 4; ++k) rect[k] = argv[++a];
    } else if (argv[a][0] != '-' && g_n_files < MAX_SONGS) {
      g_files[g_n_files++].path = argv[a];
    } else {
      fprintf(stderr, "abi_check: bad argument %s\n", argv[a]);
      return 2;
    }
  }
  printf("version %.1f\n", bl_version());

  for (int i = 0; i < g_n_raws; ++i) {
    item_t *it = &g_raws[i];
    long n_bytes;
    memset(&it->song, 0, sizeof it->song);
    it->song.sample_array = (int8_t *)read_all(it->path, &n_bytes);
    if (!it->song.sample_array) {
      fprintf(stderr, "abi_check: cannot read %s\n", it->path);
      return 1;
    }
    it->song.nSamples = (int)(n_bytes / 2);
    it->song.channels = 2;
    it->song.sample_rate = 22050;
    it->song.nb_bytes_per_sample = 2;
    it->song.duration = (uint64_t)it->duration;
    it->song.filename = strdup(it->path);
    sort_raw(&it->song, it->result);
    cold_start_line();
    it->song.force_vector.tempo = it->result[0];
    it->song.force_vector.amplitude = it->result[1];
    it->song.force_vector.frequency = it->result[2];
    it->song.force_vector.attack = it->result[3];
    printf("sorts %.9g %.9g %.9g %.9g %s\n", it->result[1], it->result[2],
           it->result[0], it->result[3], it->path);
    int16_t *pcm = (int16_t *)it->song.sample_array;
    int mean = bl_mean(pcm, it->song.nSamples);
    printf("stats %d %d %s\n", mean,
           bl_variance(pcm, it->song.nSamples, mean), it->path);
  }

  for (int i = 0; i < g_n_files; ++i) {
    item_t *it = &g_files[i];
    struct bl_song song;
    memset(&song, 0, sizeof song);
    int rc = bl_audio_decode(it->path, &song);
    printf("decode %d %d %d %d %d %d %d %llu %s\n", rc, song.nSamples,
           song.channels, song.sample_rate, song.bitrate,
           song.nb_bytes_per_sample, song.resampled,
           (unsigned long long)song.duration, it->path);
    if (rc == BL_OK)
      printf("tags %s|%s|%s|%s|%s %s\n", or_empty(song.artist),
             or_empty(song.title), or_empty(song.album),
             or_empty(song.tracknumber), or_empty(song.genre), it->path);
    bl_free_song(&song);
    analyze_file(it->path, it->result, &rc, &it->song);
    cold_start_line();
    printf("analyze %d %.9g %.9g %.9g %.9g %.9g %d %s\n", rc, it->song.force,
           it->result[0], it->result[1], it->result[2], it->result[3],
           it->song.calm_or_loud, it->path);
  }

  item_t *all[2 * MAX_SONGS];
  int n_all = 0;
  for (int i = 0; i < g_n_files; ++i) all[n_all++] = &g_files[i];
  for (int i = 0; i < g_n_raws; ++i) all[n_all++] = &g_raws[i];
  for (int i = 0; i < n_all; ++i)
    for (int j = i + 1; j < n_all; ++j)
      printf("distance %d %d %.9g %.9g\n", i, j,
             bl_distance(all[i]->song.force_vector, all[j]->song.force_vector),
             bl_cosine_similarity(all[i]->song.force_vector,
                                  all[j]->song.force_vector));
  if (g_n_files >= 2) {
    struct bl_song s[4];
    for (int k = 0; k < 4; ++k) bl_initialize_song(&s[k]);
    float d = bl_distance_file(g_files[0].path, g_files[1].path, &s[0], &s[1]);
    float c = bl_cosine_similarity_file(g_files[0].path, g_files[1].path,
                                        &s[2], &s[3]);
    printf("distance_file %.9g %.9g\n", d, c);
    for (int k = 0; k < 4; ++k) bl_free_song(&s[k]);
  }

  if (bad) {
    struct bl_song s[6];
    for (int k = 0; k < 6; ++k) bl_initialize_song(&s[k]);
    const char *good = g_n_files ? g_files[0].path : bad;
    int drc = bl_audio_decode(bad, &s[0]);
    int arc = bl_analyze(bad, &s[1]);
    float d = bl_distance_file(good, bad, &s[2], &s[3]);
    float c = bl_cosine_similarity_file(bad, good, &s[4], &s[5]);
    printf("bad %d %d %.9g %.9g %s\n", drc, arc, d, c, bad);
    for (int k = 0; k < 6; ++k) bl_free_song(&s[k]);
  }

  if (rect[0]) {
    long n_in, n_out;
    double *in = (double *)read_all(rect[0], &n_in);
    double *out = (double *)read_all(rect[1], &n_out);
    int n = (int)(n_in / sizeof(double)), width = atoi(rect[2]);
    FILE *f = fopen(rect[3], "wb");
    if (!in || !out || n_out != n_in || !f) {
      fprintf(stderr, "abi_check: bad --rect files\n");
      return 1;
    }
    bl_rectangular_filter(out, in, n, width);
    fwrite(out, sizeof(double), n, f);
    fclose(f);
    printf("rect %d %d\n", n, width);
    free(in);
    free(out);
  }

  if (threads > 0) {
    pthread_t tids[64];
    long mismatches[64];
    if (threads > 64) threads = 64;
    for (int t = 0; t < threads; ++t) {
      mismatches[t] = 0;
      if (pthread_create(&tids[t], NULL, worker, &mismatches[t]) != 0) {
        fprintf(stderr, "abi_check: pthread_create failed\n");
        return 1;
      }
    }
    long total = 0;
    for (int t = 0; t < threads; ++t) {
      pthread_join(tids[t], NULL);
      total += mismatches[t];
    }
    printf("threads %d %d %d %ld\n", threads, g_rounds, g_n_files + g_n_raws,
           total);
    if (total) status = 1;
  }
  for (int i = 0; i < g_n_files; ++i) bl_free_song(&g_files[i].song);
  for (int i = 0; i < g_n_raws; ++i) bl_free_song(&g_raws[i].song);
  return status;
}
