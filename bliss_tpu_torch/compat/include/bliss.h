/* bliss C compatibility header of the PyTorch port (bliss_tpu_torch).
 *
 * The same declarations, status codes, struct layouts and fifteen public
 * functions as the reference library's `bliss.h` (reference:
 * include/bliss.h) and as bliss_tpu/compat/include/bliss.h, so C callers
 * written against either link and run unchanged against the port's
 * libbliss.so. Analysis and decode are served by bliss_tpu_torch through an
 * embedded interpreter; see compat_shim.cc.
 */
#ifndef BLISS_TPU_COMPAT_BLISS_H_
#define BLISS_TPU_COMPAT_BLISS_H_

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* The reference header includes libav's headers, and some callers rely on
 * it (av_md5_sum in its decode test). The port's library itself is built
 * with BLISS_COMPAT_NO_LIBAV: it links no decoder of its own. */
#ifndef BLISS_COMPAT_NO_LIBAV
#include <libavformat/avformat.h>
#include <libavutil/md5.h>
#endif

#ifndef M_PI
#define M_PI 3.14159265358979323846
#endif

#define BL_VERSION 1.2

#define BL_LOUD 0
#define BL_CALM 1
#define BL_UNKNOWN 2
#define BL_UNEXPECTED -2
#define BL_OK 0

#ifdef __cplusplus
extern "C" {
#endif

struct force_vector_s {
  float tempo;
  float amplitude;
  float frequency;
  float attack;
};

struct envelope_result_s {
  float tempo;
  float attack;
};

struct bl_song {
  float force;
  struct force_vector_s force_vector;
  int8_t *sample_array;
  int channels;
  int nSamples;
  int sample_rate;
  int bitrate;
  int nb_bytes_per_sample;
  int calm_or_loud;
  int resampled;
  uint64_t duration;
  char *filename;
  char *artist;
  char *title;
  char *album;
  char *tracknumber;
  char *genre;
};

int bl_analyze(char const *const filename, struct bl_song *current_song);

float bl_distance_file(char const *const filename1,
                       char const *const filename2, struct bl_song *song1,
                       struct bl_song *song2);

float bl_distance(struct force_vector_s v_song1,
                  struct force_vector_s v_song2);

float bl_cosine_similarity_file(char const *const filename1,
                                char const *const filename2,
                                struct bl_song *song1, struct bl_song *song2);

float bl_cosine_similarity(struct force_vector_s v_song1,
                           struct force_vector_s v_song2);

void bl_envelope_sort(struct bl_song const *const song,
                      struct envelope_result_s *result);

float bl_amplitude_sort(struct bl_song const *const song);

float bl_frequency_sort(struct bl_song const *const song);

int bl_audio_decode(char const *const filename, struct bl_song *const song);

void bl_free_song(struct bl_song *const song);

float bl_version(void);

void bl_initialize_song(struct bl_song *const song);

int bl_mean(int16_t *sample_array, int nSamples);

int bl_variance(int16_t *sample_array, int nSamples, int mean);

void bl_rectangular_filter(double *sample_array_out, double *sample_array_in,
                           int nSamples, int smooth_width);

#ifdef __cplusplus
}
#endif

#endif /* BLISS_TPU_COMPAT_BLISS_H_ */
