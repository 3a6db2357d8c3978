// Native runtime core: binary replay-log (data loader) + keyframe gate.
//
// The reference's entire runtime is native C++ (ROS node, PCL, g2o); in the
// TPU build the wide math lives on-device and the host keeps the serial
// ingestion path. This library implements that path natively:
//
//  * SLOG binary session logs — a compact mmap-able replacement for rosbag
//    replay (cloud payloads are raw float32 blocks; readers get zero-copy
//    pointers), with a pre-merged time-ordered event index so the Python
//    driver does no per-event sorting or dispatch bookkeeping.
//  * The keyframe gate (keyframe_updater.hpp:41-65 semantics, including the
//    acos(q.w) angle and the integer-seconds time truncation) for the
//    high-rate VIO path.
//
// Pure C ABI (ctypes-friendly). No ROS, no external deps.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// SLOG format
// ---------------------------------------------------------------------------
// header:  magic "SLOG" | u32 version | u64 counts[4] (odom, cloud, det, gt)
//          | u32 H | u32 W | u32 max_det | u32 pad
// odom:    f64 t | u8 source | pad[7] | f64 pose[7] | f64 cov[36]
// cloud:   f64 t | u64 offset (into payload blob, xyz f32[H*W*3] then
//          valid u8[H*W])
// det:     f64 t | u32 n | pad | f32 boxes[max_det*4] | i32 cids[max_det]
//          | f32 probs[max_det]
// gt:      f64 t | f64 pose[7]
// payload blob follows all tables; event index (u8 kind | u32 idx) last.

#pragma pack(push, 1)
struct SlogHeader {
  char magic[4];
  uint32_t version;
  uint64_t n_odom, n_cloud, n_det, n_gt;
  uint32_t height, width, max_det, pad;
  uint64_t payload_bytes;
};
struct OdomRec {
  double t;
  uint8_t source;
  uint8_t pad[7];
  double pose[7];
  double cov[36];
};
struct CloudRec {
  double t;
  uint64_t offset;
};
struct GtRec {
  double t;
  double pose[7];
};
struct EventRec {
  uint8_t kind;  // 0 cloud, 1 det, 2 odom, 3 gt (delivery priority order)
  uint8_t pad[3];
  uint32_t idx;
};
#pragma pack(pop)

struct SlogWriter {
  FILE* f;
  SlogHeader hdr;
  std::vector<OdomRec> odom;
  std::vector<CloudRec> clouds;
  std::vector<uint8_t> dets;  // raw det records
  std::vector<GtRec> gt;
  std::vector<uint8_t> payload;
  size_t det_rec_size;
};

static size_t det_record_size(uint32_t max_det) {
  return sizeof(double) + sizeof(uint32_t) * 2 + max_det * (4 * sizeof(float)) +
         max_det * sizeof(int32_t) + max_det * sizeof(float);
}

SlogWriter* slog_writer_create(const char* path, uint32_t height,
                               uint32_t width, uint32_t max_det) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  SlogWriter* w = new SlogWriter();
  w->f = f;
  std::memset(&w->hdr, 0, sizeof(w->hdr));
  std::memcpy(w->hdr.magic, "SLOG", 4);
  w->hdr.version = 1;
  w->hdr.height = height;
  w->hdr.width = width;
  w->hdr.max_det = max_det;
  w->det_rec_size = det_record_size(max_det);
  return w;
}

void slog_add_odom(SlogWriter* w, double t, uint8_t source,
                   const double* pose7, const double* cov36) {
  OdomRec r;
  std::memset(&r, 0, sizeof(r));
  r.t = t;
  r.source = source;
  std::memcpy(r.pose, pose7, 7 * sizeof(double));
  if (cov36)
    std::memcpy(r.cov, cov36, 36 * sizeof(double));
  else
    for (int i = 0; i < 6; ++i) r.cov[i * 6 + i] = 1.0;
  w->odom.push_back(r);
}

void slog_add_cloud(SlogWriter* w, double t, const float* xyz,
                    const uint8_t* valid) {
  CloudRec r;
  r.t = t;
  r.offset = w->payload.size();
  size_t npix = (size_t)w->hdr.height * w->hdr.width;
  size_t xyz_bytes = npix * 3 * sizeof(float);
  size_t old = w->payload.size();
  w->payload.resize(old + xyz_bytes + npix);
  std::memcpy(w->payload.data() + old, xyz, xyz_bytes);
  std::memcpy(w->payload.data() + old + xyz_bytes, valid, npix);
  w->clouds.push_back(r);
}

void slog_add_detections(SlogWriter* w, double t, uint32_t n,
                         const float* boxes, const int32_t* cids,
                         const float* probs) {
  size_t old = w->dets.size();
  w->dets.resize(old + w->det_rec_size);
  uint8_t* p = w->dets.data() + old;
  std::memcpy(p, &t, sizeof(double));
  p += sizeof(double);
  uint32_t nn = std::min(n, w->hdr.max_det);
  std::memcpy(p, &nn, sizeof(uint32_t));
  p += sizeof(uint32_t) * 2;  // skip pad
  uint32_t md = w->hdr.max_det;
  std::memset(p, 0, md * 4 * sizeof(float));
  std::memcpy(p, boxes, nn * 4 * sizeof(float));
  p += md * 4 * sizeof(float);
  std::memset(p, 0xff, md * sizeof(int32_t));  // -1 class ids
  std::memcpy(p, cids, nn * sizeof(int32_t));
  p += md * sizeof(int32_t);
  std::memset(p, 0, md * sizeof(float));
  std::memcpy(p, probs, nn * sizeof(float));
}

void slog_add_gt(SlogWriter* w, double t, const double* pose7) {
  GtRec r;
  r.t = t;
  std::memcpy(r.pose, pose7, 7 * sizeof(double));
  w->gt.push_back(r);
}

static double det_rec_time(const SlogWriter* w, size_t i) {
  double t;
  std::memcpy(&t, w->dets.data() + i * w->det_rec_size, sizeof(double));
  return t;
}

int slog_writer_finish(SlogWriter* w) {
  w->hdr.n_odom = w->odom.size();
  w->hdr.n_cloud = w->clouds.size();
  w->hdr.n_det = w->dets.size() / (w->det_rec_size ? w->det_rec_size : 1);
  w->hdr.n_gt = w->gt.size();
  w->hdr.payload_bytes = w->payload.size();

  // pre-merged event index sorted by (t, kind priority)
  struct Ev {
    double t;
    uint8_t kind;
    uint32_t idx;
  };
  std::vector<Ev> evs;
  for (size_t i = 0; i < w->clouds.size(); ++i)
    evs.push_back({w->clouds[i].t, 0, (uint32_t)i});
  for (size_t i = 0; i < w->hdr.n_det; ++i)
    evs.push_back({det_rec_time(w, i), 1, (uint32_t)i});
  for (size_t i = 0; i < w->odom.size(); ++i)
    evs.push_back({w->odom[i].t, 2, (uint32_t)i});
  for (size_t i = 0; i < w->gt.size(); ++i)
    evs.push_back({w->gt[i].t, 3, (uint32_t)i});
  std::stable_sort(evs.begin(), evs.end(), [](const Ev& a, const Ev& b) {
    if (a.t != b.t) return a.t < b.t;
    return a.kind < b.kind;
  });

  int ok = 1;
  ok &= fwrite(&w->hdr, sizeof(w->hdr), 1, w->f) == 1;
  if (!w->odom.empty())
    ok &= fwrite(w->odom.data(), sizeof(OdomRec), w->odom.size(), w->f) ==
          w->odom.size();
  if (!w->clouds.empty())
    ok &= fwrite(w->clouds.data(), sizeof(CloudRec), w->clouds.size(), w->f) ==
          w->clouds.size();
  if (!w->dets.empty())
    ok &= fwrite(w->dets.data(), 1, w->dets.size(), w->f) == w->dets.size();
  if (!w->gt.empty())
    ok &= fwrite(w->gt.data(), sizeof(GtRec), w->gt.size(), w->f) ==
          w->gt.size();
  if (!w->payload.empty())
    ok &= fwrite(w->payload.data(), 1, w->payload.size(), w->f) ==
          w->payload.size();
  for (auto& e : evs) {
    EventRec r{e.kind, {0, 0, 0}, e.idx};
    ok &= fwrite(&r, sizeof(r), 1, w->f) == 1;
  }
  fclose(w->f);
  delete w;
  return ok ? 0 : -1;
}

// --------------------------- reader ---------------------------------------

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

struct SlogReader {
  int fd;
  size_t size;
  uint8_t* base;
  SlogHeader* hdr;
  OdomRec* odom;
  CloudRec* clouds;
  uint8_t* dets;
  GtRec* gt;
  uint8_t* payload;
  EventRec* events;
  size_t n_events;
  size_t det_rec_size;
};

SlogReader* slog_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  SlogReader* r = new SlogReader();
  r->fd = fd;
  r->size = st.st_size;
  r->base = (uint8_t*)base;
  r->hdr = (SlogHeader*)r->base;
  if (std::memcmp(r->hdr->magic, "SLOG", 4) != 0) {
    munmap(base, st.st_size);
    close(fd);
    delete r;
    return nullptr;
  }
  r->det_rec_size = det_record_size(r->hdr->max_det);
  uint8_t* p = r->base + sizeof(SlogHeader);
  r->odom = (OdomRec*)p;
  p += r->hdr->n_odom * sizeof(OdomRec);
  r->clouds = (CloudRec*)p;
  p += r->hdr->n_cloud * sizeof(CloudRec);
  r->dets = p;
  p += r->hdr->n_det * r->det_rec_size;
  r->gt = (GtRec*)p;
  p += r->hdr->n_gt * sizeof(GtRec);
  r->payload = p;
  p += r->hdr->payload_bytes;
  r->events = (EventRec*)p;
  r->n_events =
      r->hdr->n_odom + r->hdr->n_cloud + r->hdr->n_det + r->hdr->n_gt;
  return r;
}

void slog_close(SlogReader* r) {
  if (!r) return;
  munmap(r->base, r->size);
  close(r->fd);
  delete r;
}

// accessors (ctypes reads the returned pointers / fills caller buffers)
void slog_counts(SlogReader* r, uint64_t* out4) {
  out4[0] = r->hdr->n_odom;
  out4[1] = r->hdr->n_cloud;
  out4[2] = r->hdr->n_det;
  out4[3] = r->hdr->n_gt;
}
void slog_dims(SlogReader* r, uint32_t* out3) {
  out3[0] = r->hdr->height;
  out3[1] = r->hdr->width;
  out3[2] = r->hdr->max_det;
}
size_t slog_num_events(SlogReader* r) { return r->n_events; }
void slog_event(SlogReader* r, size_t i, uint8_t* kind, uint32_t* idx) {
  *kind = r->events[i].kind;
  *idx = r->events[i].idx;
}
const OdomRec* slog_odom(SlogReader* r, size_t i) { return &r->odom[i]; }
double slog_cloud_time(SlogReader* r, size_t i) { return r->clouds[i].t; }
const float* slog_cloud_xyz(SlogReader* r, size_t i) {
  return (const float*)(r->payload + r->clouds[i].offset);
}
const uint8_t* slog_cloud_valid(SlogReader* r, size_t i) {
  size_t npix = (size_t)r->hdr->height * r->hdr->width;
  return r->payload + r->clouds[i].offset + npix * 3 * sizeof(float);
}
const uint8_t* slog_det(SlogReader* r, size_t i) {
  return r->dets + i * r->det_rec_size;
}
const GtRec* slog_gt(SlogReader* r, size_t i) { return &r->gt[i]; }

// ---------------------------------------------------------------------------
// keyframe gate (keyframe_updater.hpp semantics)
// ---------------------------------------------------------------------------

struct KfGate {
  double delta_trans, delta_angle, delta_time;
  int is_first;
  double accum_distance;
  double prev_pose[7];  // t, q(wxyz)
  double prev_time;
};

KfGate* kf_gate_create(double dtrans, double dangle, double dtime) {
  KfGate* g = new KfGate();
  g->delta_trans = dtrans;
  g->delta_angle = dangle;
  g->delta_time = dtime;
  g->is_first = 1;
  g->accum_distance = 0.0;
  double ident[7] = {0, 0, 0, 1, 0, 0, 0};
  std::memcpy(g->prev_pose, ident, sizeof(ident));
  g->prev_time = 0.0;
  return g;
}
void kf_gate_destroy(KfGate* g) { delete g; }
double kf_gate_accum(KfGate* g) { return g->accum_distance; }

static void qmul(const double* a, const double* b, double* out) {
  out[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  out[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  out[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  out[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}
static void qrot(const double* q, const double* v, double* out) {
  double u[3] = {q[1], q[2], q[3]};
  double uv[3] = {u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2],
                  u[0] * v[1] - u[1] * v[0]};
  for (int i = 0; i < 3; ++i) {
    double uuv = u[(i + 1) % 3] * uv[(i + 2) % 3] -
                 u[(i + 2) % 3] * uv[(i + 1) % 3];
    out[i] = v[i] + 2.0 * (q[0] * uv[i] + uuv);
  }
}

int kf_gate_update(KfGate* g, const double* pose7, double stamp) {
  if (g->is_first) {
    g->is_first = 0;
    g->prev_time = stamp;
    std::memcpy(g->prev_pose, pose7, 7 * sizeof(double));
    return 1;
  }
  // delta = prev^-1 * pose
  double qc[4] = {g->prev_pose[3], -g->prev_pose[4], -g->prev_pose[5],
                  -g->prev_pose[6]};
  double dt_vec[3] = {pose7[0] - g->prev_pose[0], pose7[1] - g->prev_pose[1],
                      pose7[2] - g->prev_pose[2]};
  double t_rel[3];
  qrot(qc, dt_vec, t_rel);
  double q_cur[4] = {pose7[3], pose7[4], pose7[5], pose7[6]};
  double q_rel[4];
  qmul(qc, q_cur, q_rel);

  double dx = std::sqrt(t_rel[0] * t_rel[0] + t_rel[1] * t_rel[1] +
                        t_rel[2] * t_rel[2]);
  double w = q_rel[0];
  if (w > 1.0) w = 1.0;
  if (w < -1.0) w = -1.0;
  double da = std::acos(w);  // reference quirk: acos(w), not 2*acos(|w|)

  // reference quirk: ROS Duration .sec integer truncation
  long dt_sec = (long)(stamp - g->prev_time);
  if (dt_sec < g->delta_time && dx < g->delta_trans && da < g->delta_angle)
    return 0;

  g->accum_distance += dx;
  std::memcpy(g->prev_pose, pose7, 7 * sizeof(double));
  g->prev_time = stamp;
  return 1;
}

}  // extern "C"
