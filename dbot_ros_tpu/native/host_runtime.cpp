// Native host-runtime components for dbot_ros_tpu.
//
// The reference implements its host-side plumbing in C++ (mesh loading —
// dbot SimpleWavefrontObjectModelLoader; depth image conversion —
// dbot_ros ri::to_eigen; frame buffering — ObjectTrackerRos's queue).
// These are the native equivalents, exposed with a C ABI consumed via
// ctypes (dbot_ros_tpu/native/__init__.py). The device compute path stays
// JAX/XLA/Pallas; this library handles the parts that should never touch
// the Python interpreter per frame: OBJ parsing at startup, uint16→float
// depth conversion + strided downsampling at camera rate, and a
// lock-free-ish single-producer/single-consumer frame ring buffer that
// decouples a camera thread from the tracking loop.
//
// Build: python -m dbot_ros_tpu.native.build  (g++ -O3 -shared -fPIC)

#include <atomic>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Wavefront OBJ parsing (ref: SimpleWavefrontObjectModelLoader, D3)
// ---------------------------------------------------------------------------

// Parses `path`; on success (return 0) fills malloc'd arrays:
//   *out_vertices: n_vertices x 3 doubles
//   *out_faces:    n_faces x 3 int64 (fan-triangulated, 0-based)
// Caller frees both with dbot_free. Returns nonzero on error.
int dbot_parse_obj(const char* path, void** out_vertices,
                   long long* out_n_vertices, void** out_faces,
                   long long* out_n_faces) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  std::vector<double> verts;
  std::vector<long long> faces;
  char line[8192];
  while (fgets(line, sizeof line, f)) {
    const char* s = line;
    while (*s == ' ' || *s == '\t') ++s;
    if (s[0] == 'v' && (s[1] == ' ' || s[1] == '\t')) {
      double x, y, z;
      if (sscanf(s + 1, "%lf %lf %lf", &x, &y, &z) != 3) {
        fclose(f);
        return 2;
      }
      verts.push_back(x);
      verts.push_back(y);
      verts.push_back(z);
    } else if (s[0] == 'f' && (s[1] == ' ' || s[1] == '\t')) {
      // collect vertex indices of the (possibly polygonal) face
      long long idx[64];
      int n = 0;
      const char* p = s + 1;
      long long nv = (long long)(verts.size() / 3);
      while (*p && n < 64) {
        while (*p == ' ' || *p == '\t') ++p;
        if (!*p || *p == '\n' || *p == '\r') break;
        long long v = strtoll(p, (char**)&p, 10);
        if (v == 0) {
          fclose(f);
          return 3;
        }
        idx[n++] = v > 0 ? v - 1 : nv + v;
        // skip /vt/vn suffixes
        while (*p && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r')
          ++p;
      }
      for (int k = 1; k + 1 < n; ++k) {  // fan triangulation
        faces.push_back(idx[0]);
        faces.push_back(idx[k]);
        faces.push_back(idx[k + 1]);
      }
    }
  }
  fclose(f);
  long long nv = (long long)(verts.size() / 3);
  long long nf = (long long)(faces.size() / 3);
  for (size_t i = 0; i < faces.size(); ++i) {
    if (faces[i] < 0 || faces[i] >= nv) return 4;
  }
  double* v = (double*)malloc(sizeof(double) * verts.size());
  long long* fc = (long long*)malloc(sizeof(long long) * faces.size());
  if ((!v && !verts.empty()) || (!fc && !faces.empty())) {
    free(v);
    free(fc);
    return 5;
  }
  memcpy(v, verts.data(), sizeof(double) * verts.size());
  memcpy(fc, faces.data(), sizeof(long long) * faces.size());
  *out_vertices = v;
  *out_n_vertices = nv;
  *out_faces = fc;
  *out_n_faces = nf;
  return 0;
}

void dbot_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// Depth preprocessing (ref: ri::to_eigen, R8): uint16 mm → float32 m,
// strided downsampling, invalid (0) → `invalid` sentinel (typically NaN).
// ---------------------------------------------------------------------------

int dbot_preprocess_depth(const uint16_t* src, long long h, long long w,
                          long long downsampling, long long /*flags*/,
                          float invalid, float* dst) {
  if (downsampling < 1) return 1;
  long long oh = h / downsampling, ow = w / downsampling;
  for (long long r = 0; r < oh; ++r) {
    const uint16_t* row = src + (r * downsampling) * w;
    float* out = dst + r * ow;
    for (long long c = 0; c < ow; ++c) {
      uint16_t d = row[c * downsampling];
      out[c] = d == 0 ? invalid : (float)d * 1e-3f;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// SPSC frame ring buffer (ref: the subscriber-thread ↔ tracker-thread
// decoupling in ObjectTrackerRos, R5/P4). Fixed capacity, drop-oldest on
// overflow (a tracker wants the freshest frame, not backpressure).
// ---------------------------------------------------------------------------

struct DbotRing {
  float* data;
  long long frame_floats;
  long long capacity;
  std::atomic<long long> head;  // next write slot (monotonic)
  std::atomic<long long> tail;  // next read slot (monotonic)
  double* stamps;
};

void* dbot_ring_create(long long frame_floats, long long capacity) {
  DbotRing* r = new DbotRing();
  r->data = (float*)malloc(sizeof(float) * frame_floats * capacity);
  r->stamps = (double*)malloc(sizeof(double) * capacity);
  r->frame_floats = frame_floats;
  r->capacity = capacity;
  r->head.store(0);
  r->tail.store(0);
  if (!r->data || !r->stamps) {
    free(r->data);
    free(r->stamps);
    delete r;
    return nullptr;
  }
  return r;
}

void dbot_ring_destroy(void* ring) {
  DbotRing* r = (DbotRing*)ring;
  if (!r) return;
  free(r->data);
  free(r->stamps);
  delete r;
}

// Producer: push a frame (copies). Drops the oldest unread frame when full.
int dbot_ring_push(void* ring, const float* frame, double stamp) {
  DbotRing* r = (DbotRing*)ring;
  long long h = r->head.load(std::memory_order_relaxed);
  long long t = r->tail.load(std::memory_order_acquire);
  if (h - t >= r->capacity) {
    // full → drop oldest (advance tail); SPSC with drop-oldest from the
    // producer side requires the consumer to tolerate a skipped slot,
    // which pop handles by re-checking indices.
    r->tail.store(t + 1, std::memory_order_release);
  }
  memcpy(r->data + (h % r->capacity) * r->frame_floats, frame,
         sizeof(float) * r->frame_floats);
  r->stamps[h % r->capacity] = stamp;
  r->head.store(h + 1, std::memory_order_release);
  return 0;
}

// Consumer: pop the *latest* frame, discarding older ones (returns the
// number of frames skipped, -1 if empty).
long long dbot_ring_pop_latest(void* ring, float* out, double* stamp) {
  DbotRing* r = (DbotRing*)ring;
  long long h = r->head.load(std::memory_order_acquire);
  long long t = r->tail.load(std::memory_order_relaxed);
  if (t >= h) return -1;
  long long latest = h - 1;
  memcpy(out, r->data + (latest % r->capacity) * r->frame_floats,
         sizeof(float) * r->frame_floats);
  if (stamp) *stamp = r->stamps[latest % r->capacity];
  r->tail.store(h, std::memory_order_release);
  return latest - t;  // frames skipped
}

long long dbot_ring_size(void* ring) {
  DbotRing* r = (DbotRing*)ring;
  return r->head.load() - r->tail.load();
}

}  // extern "C"
