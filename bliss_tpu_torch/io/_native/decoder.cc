// bliss_tpu native audio decoder.
//
// Host-side decode stage of the TPU pipeline: demux + decode any audio format
// libav supports, then normalize to the canonical analysis contract —
// interleaved signed 16-bit PCM, 22 050 Hz, stereo — matching the reference
// contract (reference: src/decode.c:7-9 SAMPLE_RATE/NB_BYTES_PER_SAMPLE/
// CHANNELS, and the swresample conversion at src/decode.c:311-346) so that
// decoded PCM is bit-identical to the reference (tests/test_decode.c MD5s).
//
// This is a fresh C++ implementation (RAII, Result-style errors, no realloc
// growth dance); only the *behavioral contract* is shared with the reference.
//
// Exposed as a C ABI consumed from Python via ctypes (no pybind11 in image).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/dict.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

namespace {

constexpr int kTargetRate = 22050;   // reference: src/decode.c:8
constexpr int kTargetChannels = 2;   // reference: src/decode.c:9
constexpr int kBytesPerSample = 2;   // reference: src/decode.c:7

struct DecodeState {
  std::vector<int16_t> samples;  // interleaved s16 stereo @ 22.05 kHz
  std::string error;
};

// Small RAII helpers -------------------------------------------------------

struct FormatCtx {
  AVFormatContext* p = nullptr;
  ~FormatCtx() {
    if (p) avformat_close_input(&p);
  }
};

struct CodecCtx {
  AVCodecContext* p = nullptr;
  ~CodecCtx() {
    if (p) avcodec_free_context(&p);
  }
};

struct SwrCtx {
  SwrContext* p = nullptr;
  ~SwrCtx() {
    if (p) swr_free(&p);
  }
};

struct Frame {
  AVFrame* p = nullptr;
  Frame() : p(av_frame_alloc()) {}
  ~Frame() {
    if (p) av_frame_free(&p);
  }
};

struct Packet {
  AVPacket* p = nullptr;
  Packet() : p(av_packet_alloc()) {}
  ~Packet() {
    if (p) av_packet_free(&p);
  }
};

// Append a block of interleaved s16 stereo frames to the output buffer.
void append_s16(DecodeState& st, const int16_t* data, int nb_frames) {
  st.samples.insert(st.samples.end(), data,
                    data + static_cast<size_t>(nb_frames) * kTargetChannels);
}

// Run one decoded frame through swresample (or flush when frame == nullptr)
// and append the converted stereo/s16/22.05kHz output.
bool convert_and_append(DecodeState& st, SwrContext* swr, const AVFrame* frame,
                        int in_rate) {
  int in_samples = frame ? frame->nb_samples : 0;
  int64_t delay = swr_get_delay(swr, in_rate);
  int out_cap = static_cast<int>(
      av_rescale_rnd(delay + in_samples, kTargetRate, in_rate, AV_ROUND_UP));
  if (out_cap <= 0) out_cap = 256;
  std::vector<int16_t> out(static_cast<size_t>(out_cap) * kTargetChannels);
  uint8_t* out_planes[1] = {reinterpret_cast<uint8_t*>(out.data())};
  const uint8_t** in_planes =
      frame ? const_cast<const uint8_t**>(frame->extended_data) : nullptr;
  int got = swr_convert(swr, out_planes, out_cap, in_planes, in_samples);
  if (got < 0) {
    st.error = "swr_convert failed";
    return false;
  }
  if (got > 0) append_s16(st, out.data(), got);
  return true;
}

std::string get_tag(AVDictionary* meta, const char* key,
                    const char* fallback) {
  AVDictionaryEntry* e = av_dict_get(meta, key, nullptr, 0);
  return e ? std::string(e->value) : std::string(fallback);
}

char* dup_cstr(const std::string& s) {
  char* out = static_cast<char*>(std::malloc(s.size() + 1));
  std::memcpy(out, s.c_str(), s.size() + 1);
  return out;
}

}  // namespace

extern "C" {

// Mirror of the analysis-relevant fields of the reference bl_song
// (reference: include/bliss.h:49-67), minus the results which live on the
// Python/JAX side.
typedef struct {
  int16_t* samples;  // interleaved s16, owned; free via bt_free_decoded
  int64_t n_samples; // total interleaved sample count (frames * channels)
  int32_t channels;
  int32_t sample_rate;
  int32_t bitrate;
  int32_t nb_bytes_per_sample;
  int32_t resampled;
  uint64_t duration;  // whole seconds, truncated (reference: src/decode.c:235)
  char* artist;
  char* title;
  char* album;
  char* tracknumber;
  char* genre;
  char* error;  // nullptr on success
} bt_decoded;

// Tag surface mirrors the reference defaults (reference: src/decode.c:261-309).
static void fill_tags(AVFormatContext* fmt, bt_decoded* out) {
  AVDictionary* meta = fmt->metadata;
  std::string track = get_tag(meta, "track", "");
  track = track.substr(0, track.find('/'));
  out->tracknumber = dup_cstr(track);
  out->title = dup_cstr(get_tag(meta, "title", "<no title>"));
  out->artist = dup_cstr(get_tag(meta, "artist", "<no artist>"));
  out->album = dup_cstr(get_tag(meta, "album", "<no album>"));
  out->genre = dup_cstr(get_tag(meta, "genre", "<no genre>"));
}

int bt_decode(const char* filename, bt_decoded* out) {
  std::memset(out, 0, sizeof(*out));
  DecodeState st;
  av_log_set_level(AV_LOG_QUIET);

  FormatCtx fmt;
  if (avformat_open_input(&fmt.p, filename, nullptr, nullptr) < 0) {
    out->error = dup_cstr(std::string("could not open file: ") + filename);
    return -1;
  }
  if (avformat_find_stream_info(fmt.p, nullptr) < 0) {
    out->error = dup_cstr("could not find stream info");
    return -1;
  }
  const AVCodec* codec = nullptr;
  int stream_idx =
      av_find_best_stream(fmt.p, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
  if (stream_idx < 0 || !codec) {
    out->error = dup_cstr("no audio stream found");
    return -1;
  }
  AVCodecParameters* par = fmt.p->streams[stream_idx]->codecpar;

  CodecCtx cc;
  cc.p = avcodec_alloc_context3(codec);
  if (!cc.p || avcodec_parameters_to_context(cc.p, par) < 0) {
    out->error = dup_cstr("could not set up codec context");
    return -1;
  }
  // Single-threaded codec, deliberately (the reference uses auto frame
  // threads, reference src/decode.c:91-92). The scan pipeline already
  // parallelizes across SONGS with one decode per worker thread
  // (io/decoder.py iter_decode), so per-codec frame threads would only
  // oversubscribe the cores; and it keeps the decode-cost accounting
  // exact — iter_decode charges decode CPU via the worker's
  // CLOCK_THREAD_CPUTIME_ID, which cannot see avcodec-spawned helper
  // threads, and the capacity projection divides that number.
  // BLISS_TPU_DECODE_THREADS overrides for one-shot big-file latency.
  const char* threads_env = getenv("BLISS_TPU_DECODE_THREADS");
  cc.p->thread_count = threads_env ? atoi(threads_env) : 1;
  cc.p->thread_type = FF_THREAD_FRAME;
  if (avcodec_open2(cc.p, codec, nullptr) < 0) {
    out->error = dup_cstr("could not open codec");
    return -1;
  }

  // Canonicalization: anything that is not already s16 stereo @ 22.05 kHz
  // goes through swresample. (The reference skips the channel check, so a
  // mono s16 22.05 kHz file passes through un-upmixed while still being
  // reported as stereo — reference src/decode.c:314-318,193; fixed here.)
  bool needs_resample = par->format != AV_SAMPLE_FMT_S16 ||
                        par->sample_rate != kTargetRate ||
                        par->ch_layout.nb_channels != kTargetChannels;
  SwrCtx swr;
  if (needs_resample) {
    AVChannelLayout out_layout = AV_CHANNEL_LAYOUT_STEREO;
    if (swr_alloc_set_opts2(&swr.p, &out_layout, AV_SAMPLE_FMT_S16,
                            kTargetRate, &par->ch_layout,
                            static_cast<AVSampleFormat>(par->format),
                            par->sample_rate, 0, nullptr) < 0 ||
        swr_init(swr.p) < 0) {
      out->error = dup_cstr("could not init resampler");
      return -1;
    }
  }

  // Reserve based on the container's duration estimate to avoid regrowth.
  if (fmt.p->duration > 0) {
    int64_t est_frames =
        fmt.p->duration * kTargetRate / AV_TIME_BASE + kTargetRate;
    st.samples.reserve(static_cast<size_t>(est_frames) * kTargetChannels);
  }

  Frame frame;
  Packet pkt;
  if (!frame.p || !pkt.p) {
    out->error = dup_cstr("allocation failure");
    return -1;
  }

  auto handle_frame = [&](const AVFrame* f) -> bool {
    if (needs_resample)
      return convert_and_append(st, swr.p, f, par->sample_rate);
    // Passthrough: already interleaved s16 stereo at the target rate.
    const int16_t* data = reinterpret_cast<const int16_t*>(f->extended_data[0]);
    st.samples.insert(st.samples.end(), data,
                      data + static_cast<size_t>(f->nb_samples) *
                                 f->ch_layout.nb_channels);
    return true;
  };

  // Demux → decode loop, then codec drain, then resampler flush.
  bool ok = true;
  while (ok && av_read_frame(fmt.p, pkt.p) == 0) {
    if (pkt.p->stream_index == stream_idx) {
      if (avcodec_send_packet(cc.p, pkt.p) == 0) {
        while (avcodec_receive_frame(cc.p, frame.p) == 0)
          if (!(ok = handle_frame(frame.p))) break;
      }
    }
    av_packet_unref(pkt.p);
  }
  if (ok) {
    avcodec_send_packet(cc.p, nullptr);
    while (avcodec_receive_frame(cc.p, frame.p) == 0)
      if (!(ok = handle_frame(frame.p))) break;
  }
  if (ok && needs_resample)
    ok = convert_and_append(st, swr.p, nullptr, par->sample_rate);

  if (!ok) {
    out->error = dup_cstr(st.error.empty() ? "decode failed" : st.error);
    return -1;
  }
  if (st.samples.empty()) {
    out->error = dup_cstr("no valid samples decoded");
    return -1;
  }

  // Hand the buffer off as a malloc'd block (stable ABI for ctypes).
  out->n_samples = static_cast<int64_t>(st.samples.size());
  out->samples = static_cast<int16_t*>(
      std::malloc(st.samples.size() * sizeof(int16_t)));
  std::memcpy(out->samples, st.samples.data(),
              st.samples.size() * sizeof(int16_t));
  out->channels = kTargetChannels;
  out->sample_rate = kTargetRate;
  out->nb_bytes_per_sample = kBytesPerSample;
  out->resampled = needs_resample ? 1 : 0;
  out->bitrate = static_cast<int32_t>(fmt.p->bit_rate);
  out->duration = fmt.p->duration > 0
                      ? static_cast<uint64_t>(fmt.p->duration) /
                            static_cast<uint64_t>(AV_TIME_BASE)
                      : 0;
  fill_tags(fmt.p, out);
  out->error = nullptr;
  return 0;
}

// Metadata-only probe: container open + stream info + tags, NO packet
// decode. Used by library scans and tag lookups where the PCM is not needed
// (a full decode is ~100x the cost). samples stays null / n_samples 0; the
// audio properties describe the SOURCE stream (pre-canonicalization), with
// `resampled` flagging whether a decode would go through swresample.
int bt_probe(const char* filename, bt_decoded* out) {
  std::memset(out, 0, sizeof(*out));
  av_log_set_level(AV_LOG_QUIET);

  FormatCtx fmt;
  if (avformat_open_input(&fmt.p, filename, nullptr, nullptr) < 0) {
    out->error = dup_cstr(std::string("could not open file: ") + filename);
    return -1;
  }
  if (avformat_find_stream_info(fmt.p, nullptr) < 0) {
    out->error = dup_cstr("could not find stream info");
    return -1;
  }
  int stream_idx =
      av_find_best_stream(fmt.p, AVMEDIA_TYPE_AUDIO, -1, -1, nullptr, 0);
  if (stream_idx < 0) {
    out->error = dup_cstr("no audio stream found");
    return -1;
  }
  AVCodecParameters* par = fmt.p->streams[stream_idx]->codecpar;
  out->channels = par->ch_layout.nb_channels;
  out->sample_rate = par->sample_rate;
  out->nb_bytes_per_sample = av_get_bytes_per_sample(
      static_cast<AVSampleFormat>(par->format));
  out->resampled = (par->format != AV_SAMPLE_FMT_S16 ||
                    par->sample_rate != kTargetRate ||
                    par->ch_layout.nb_channels != kTargetChannels)
                       ? 1
                       : 0;
  out->bitrate = static_cast<int32_t>(fmt.p->bit_rate);
  out->duration = fmt.p->duration > 0
                      ? static_cast<uint64_t>(fmt.p->duration) /
                            static_cast<uint64_t>(AV_TIME_BASE)
                      : 0;
  fill_tags(fmt.p, out);
  out->error = nullptr;
  return 0;
}

// ---------------------------------------------------------------------------
// Encoder: interleaved s16 stereo PCM -> any libav-supported audio file.
//
// The reference has no encoder; this exists so the framework can GENERATE
// its own test/bench fixtures across codecs (compressed FLAC, mp3, ogg,
// wav) instead of depending on pre-encoded files — feeding the decode
// MD5/round-trip tests and the per-codec decode-cost model in bench.py.
// Container is inferred from the filename extension; `codec_name`
// optionally overrides the container's default audio codec.

namespace {

struct OutFormatCtx {
  AVFormatContext* p = nullptr;
  ~OutFormatCtx() {
    if (p) {
      if (p->pb && !(p->oformat->flags & AVFMT_NOFILE)) avio_closep(&p->pb);
      avformat_free_context(p);
    }
  }
};

AVSampleFormat pick_sample_fmt(const AVCodec* codec) {
  if (!codec->sample_fmts) return AV_SAMPLE_FMT_S16;
  // prefer s16 (lossless passthrough), then planar s16, else the first
  for (const AVSampleFormat* f = codec->sample_fmts;
       *f != AV_SAMPLE_FMT_NONE; ++f)
    if (*f == AV_SAMPLE_FMT_S16) return *f;
  for (const AVSampleFormat* f = codec->sample_fmts;
       *f != AV_SAMPLE_FMT_NONE; ++f)
    if (*f == AV_SAMPLE_FMT_S16P) return *f;
  return codec->sample_fmts[0];
}

}  // namespace

int bt_encode(const char* filename, const int16_t* samples, int64_t n_samples,
              int32_t sample_rate, const char* codec_name, char** error) {
  auto fail = [&](const std::string& msg) {
    if (error) *error = dup_cstr(msg);
    return -1;
  };
  if (!samples || n_samples <= 0 || (n_samples % kTargetChannels) != 0)
    return fail("encode: need non-empty interleaved stereo samples");
  av_log_set_level(AV_LOG_QUIET);

  OutFormatCtx ofmt;
  if (avformat_alloc_output_context2(&ofmt.p, nullptr, nullptr, filename) < 0 ||
      !ofmt.p)
    return fail(std::string("encode: unknown output format for ") + filename);

  const AVCodec* codec =
      (codec_name && *codec_name)
          ? avcodec_find_encoder_by_name(codec_name)
          : avcodec_find_encoder(ofmt.p->oformat->audio_codec);
  if (!codec)
    return fail(std::string("encode: encoder not available: ") +
                (codec_name && *codec_name ? codec_name : "<container default>"));

  CodecCtx cc;
  cc.p = avcodec_alloc_context3(codec);
  if (!cc.p) return fail("encode: could not alloc codec context");
  AVChannelLayout stereo = AV_CHANNEL_LAYOUT_STEREO;
  av_channel_layout_copy(&cc.p->ch_layout, &stereo);
  cc.p->sample_rate = sample_rate;
  cc.p->sample_fmt = pick_sample_fmt(codec);
  cc.p->time_base = AVRational{1, sample_rate};
  cc.p->bit_rate = 128000;  // used by lossy codecs only
  if (ofmt.p->oformat->flags & AVFMT_GLOBALHEADER)
    cc.p->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(cc.p, codec, nullptr) < 0)
    return fail(std::string("encode: could not open encoder ") +
                codec->name);

  AVStream* stream = avformat_new_stream(ofmt.p, nullptr);
  if (!stream || avcodec_parameters_from_context(stream->codecpar, cc.p) < 0)
    return fail("encode: could not create output stream");
  stream->time_base = cc.p->time_base;

  if (!(ofmt.p->oformat->flags & AVFMT_NOFILE) &&
      avio_open(&ofmt.p->pb, filename, AVIO_FLAG_WRITE) < 0)
    return fail(std::string("encode: could not open for writing: ") +
                filename);
  if (avformat_write_header(ofmt.p, nullptr) < 0)
    return fail("encode: could not write header");

  // s16 interleaved -> the encoder's sample format (same rate/layout)
  SwrCtx swr;
  AVChannelLayout in_layout = AV_CHANNEL_LAYOUT_STEREO;
  if (swr_alloc_set_opts2(&swr.p, &cc.p->ch_layout, cc.p->sample_fmt,
                          sample_rate, &in_layout, AV_SAMPLE_FMT_S16,
                          sample_rate, 0, nullptr) < 0 ||
      swr_init(swr.p) < 0)
    return fail("encode: could not init sample-format converter");

  Packet pkt;
  Frame frame;
  if (!pkt.p || !frame.p) return fail("encode: allocation failure");
  const int chunk =
      cc.p->frame_size > 0 ? cc.p->frame_size : 4096;
  frame.p->format = cc.p->sample_fmt;
  av_channel_layout_copy(&frame.p->ch_layout, &cc.p->ch_layout);
  frame.p->sample_rate = sample_rate;
  frame.p->nb_samples = chunk;
  if (av_frame_get_buffer(frame.p, 0) < 0)
    return fail("encode: could not alloc frame buffer");

  auto drain = [&](AVFrame* f) -> bool {
    if (avcodec_send_frame(cc.p, f) < 0) return false;
    for (;;) {
      int r = avcodec_receive_packet(cc.p, pkt.p);
      if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) return true;
      if (r < 0) return false;
      av_packet_rescale_ts(pkt.p, cc.p->time_base, stream->time_base);
      pkt.p->stream_index = stream->index;
      if (av_interleaved_write_frame(ofmt.p, pkt.p) < 0) return false;
    }
  };

  const int64_t total_frames = n_samples / kTargetChannels;
  int64_t pos = 0;
  while (pos < total_frames) {
    int in_frames = static_cast<int>(
        std::min<int64_t>(chunk, total_frames - pos));
    if (av_frame_make_writable(frame.p) < 0)
      return fail("encode: frame not writable");
    const uint8_t* in_planes[1] = {reinterpret_cast<const uint8_t*>(
        samples + pos * kTargetChannels)};
    int got = swr_convert(swr.p, frame.p->extended_data, chunk, in_planes,
                          in_frames);
    if (got < 0) return fail("encode: sample-format conversion failed");
    frame.p->nb_samples = got;
    frame.p->pts = pos;
    if (got > 0 && !drain(frame.p))
      return fail(std::string("encode: encoder rejected frame (") +
                  codec->name + ")");
    pos += in_frames;
  }
  if (!drain(nullptr)) return fail("encode: encoder flush failed");
  if (av_write_trailer(ofmt.p) < 0)
    return fail("encode: could not write trailer");
  if (error) *error = nullptr;
  return 0;
}

void bt_free_decoded(bt_decoded* d) {
  if (!d) return;
  std::free(d->samples);
  std::free(d->artist);
  std::free(d->title);
  std::free(d->album);
  std::free(d->tracknumber);
  std::free(d->genre);
  std::free(d->error);
  std::memset(d, 0, sizeof(*d));
}

void bt_free_cstr(char* s) { std::free(s); }

const char* bt_version() { return "bliss-tpu-io 0.1.0"; }

}  // extern "C"
