// Native OBJ tokenizer/parser — the hot loop of mesh loading (a copy of the
// JAX package's dxrvoxelizer_tpu/utils/_native/objparse.cpp).
//
// The reference's loader is C++ with a per-token fscanf loop
// (reference: DXRVoxelizer/XUSG/Optional/XUSGObjLoader.cpp:72-164). This
// parser covers the same grammar — v / vn / vt records, face formats
// "v", "v/vt", "v//vn", "v/vt/vn", polygon fan triangulation, 1-based and
// negative (relative to vertices-so-far) indices — as a single-pass scan
// over an in-memory buffer. Post-processing (DX z-flip, vertex splitting on
// normal mismatch, normal recomputation, AABB) stays in the Python layer
// (utils/objloader.py), which is already vectorized; this file removes the
// text-parsing bottleneck.
//
// C ABI (ctypes): objparse_load() -> opaque handle; accessors copy into
// caller-provided buffers; objparse_free() releases.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct ParseResult {
  std::vector<float> positions;   // 3 per vertex
  std::vector<float> normals;     // 3 per vn record
  std::vector<int64_t> corner_v;  // resolved 0-based vertex index per corner
  std::vector<int64_t> corner_vn; // resolved 0-based normal index, -1 if none
};

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

// strtof/strtol on a bounded buffer; the file buffer is NUL-terminated.
inline const char* parse_float(const char* p, float* out) {
  char* q;
  *out = strtof(p, &q);
  return q;
}

inline const char* parse_int(const char* p, long long* out) {
  char* q;
  *out = strtoll(p, &q, 10);
  return q;
}

}  // namespace

extern "C" {

void* objparse_load(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(size) + 1);
  if (size > 0 && fread(buf.data(), 1, static_cast<size_t>(size), f) !=
                      static_cast<size_t>(size)) {
    fclose(f);
    return nullptr;
  }
  fclose(f);
  buf[static_cast<size_t>(size)] = '\0';

  auto* r = new ParseResult();
  r->positions.reserve(1 << 16);
  r->corner_v.reserve(1 << 17);

  const char* p = buf.data();
  const char* end = buf.data() + size;

  // face-corner scratch for fan triangulation
  long long fv[3] = {0, 0, 0};
  long long fn[3] = {-1, -1, -1};

  while (p < end) {
    p = skip_ws(p, end);
    if (p >= end) break;
    const char c0 = *p;
    if (c0 == 'v') {
      const char c1 = p[1];
      if (c1 == ' ' || c1 == '\t') {
        float x, y, z;
        p = parse_float(p + 2, &x);
        p = parse_float(p, &y);
        p = parse_float(p, &z);
        r->positions.push_back(x);
        r->positions.push_back(y);
        r->positions.push_back(z);
      } else if (c1 == 'n' && (p[2] == ' ' || p[2] == '\t')) {
        float x, y, z;
        p = parse_float(p + 3, &x);
        p = parse_float(p, &y);
        p = parse_float(p, &z);
        r->normals.push_back(x);
        r->normals.push_back(y);
        r->normals.push_back(z);
      }
      // "vt" and any other v* record: skip (texcoords are never stored,
      // XUSGObjLoader.cpp:160 reserves but never writes them)
      p = next_line(p, end);
    } else if (c0 == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      const long long nv = static_cast<long long>(r->positions.size() / 3);
      const long long nn = static_cast<long long>(r->normals.size() / 3);
      p += 2;
      int corner = 0;
      while (true) {
        p = skip_ws(p, end);
        if (p >= end || *p == '\n') break;
        long long vi = 0, ni = -1;
        const char* q = parse_int(p, &vi);
        if (q == p) break;  // no integer -> stop (comment junk etc.)
        p = q;
        if (*p == '/') {
          ++p;
          if (*p == '/') {  // v//vn
            ++p;
            p = parse_int(p, &ni);
          } else {  // v/vt or v/vt/vn
            long long ti = 0;
            p = parse_int(p, &ti);
            if (*p == '/') {
              ++p;
              p = parse_int(p, &ni);
            }
          }
        }
        // 1-based / negative-relative resolution (XUSGObjLoader.cpp:243)
        const long long v0 = vi < 0 ? vi + nv : vi - 1;
        const long long n0 = ni == -1 ? -1 : (ni < 0 ? ni + nn : ni - 1);
        if (corner < 2) {
          fv[corner] = v0;
          fn[corner] = n0;
        } else {
          fv[2] = v0;
          fn[2] = n0;
          r->corner_v.push_back(fv[0]);
          r->corner_v.push_back(fv[1]);
          r->corner_v.push_back(fv[2]);
          r->corner_vn.push_back(fn[0]);
          r->corner_vn.push_back(fn[1]);
          r->corner_vn.push_back(fn[2]);
          // fan: (0, k, k+1) (XUSGObjLoader.cpp:263-297)
          fv[1] = fv[2];
          fn[1] = fn[2];
        }
        ++corner;
      }
      p = next_line(p, end);
    } else {
      p = next_line(p, end);
    }
  }
  return r;
}

int64_t objparse_num_vertices(void* h) {
  return static_cast<ParseResult*>(h)->positions.size() / 3;
}
int64_t objparse_num_normals(void* h) {
  return static_cast<ParseResult*>(h)->normals.size() / 3;
}
int64_t objparse_num_corners(void* h) {
  return static_cast<ParseResult*>(h)->corner_v.size();
}
void objparse_copy_positions(void* h, float* out) {
  auto* r = static_cast<ParseResult*>(h);
  memcpy(out, r->positions.data(), r->positions.size() * sizeof(float));
}
void objparse_copy_normals(void* h, float* out) {
  auto* r = static_cast<ParseResult*>(h);
  memcpy(out, r->normals.data(), r->normals.size() * sizeof(float));
}
void objparse_copy_corners(void* h, int64_t* v, int64_t* vn) {
  auto* r = static_cast<ParseResult*>(h);
  memcpy(v, r->corner_v.data(), r->corner_v.size() * sizeof(int64_t));
  memcpy(vn, r->corner_vn.data(), r->corner_vn.size() * sizeof(int64_t));
}
void objparse_free(void* h) { delete static_cast<ParseResult*>(h); }

}  // extern "C"
