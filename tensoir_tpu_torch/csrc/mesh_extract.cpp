// Host iso-surface extraction (marching tetrahedra) for mesh export: the
// port's own copy of tensoir_tpu/native/mesh_extract.cpp, line for line in
// its arithmetic, so that both give the same vertices and faces in the same
// order when built with the same flags (kernels/build.py: g++ -O3
// -march=native -std=c++17).
//
// The dense alpha grid is pulled to the host and triangulated here, as the
// JAX package does: this is host code, not a port of a TPU kernel. Marching
// tetrahedra (each voxel split into 6 tets) needs no 256-entry case tables,
// is watertight on shared faces, and vectorizes trivially.
//
// C API (ctypes): mesh_extract() triangulates, mesh_free() releases buffers.
// Vertices are emitted per-edge with a hash-based weld so shared edges reuse
// vertices (compact meshes, consistent topology).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

// Kuhn 6-tetrahedra decomposition of a cube around the main diagonal 0-7
// (corner c = (x + (c&1), y + ((c>>1)&1), z + ((c>>2)&1))). This split is
// face-consistent between neighboring cubes, so the surface is watertight.
static const int kTets[6][4] = {
    {0, 1, 3, 7}, {0, 1, 5, 7}, {0, 2, 3, 7},
    {0, 2, 6, 7}, {0, 4, 5, 7}, {0, 4, 6, 7},
};

inline uint64_t EdgeKey(uint64_t a, uint64_t b) {
  if (a > b) std::swap(a, b);
  return (a << 32) | b;
}

struct Extractor {
  const float* grid;
  int64_t nx, ny, nz;
  float level;
  const float* origin;
  const float* spacing;

  std::vector<float> verts;
  std::vector<int32_t> faces;
  std::unordered_map<uint64_t, int32_t> edge_cache;

  inline float Value(int64_t x, int64_t y, int64_t z) const {
    return grid[(x * ny + y) * nz + z];
  }

  inline uint64_t CornerId(int64_t x, int64_t y, int64_t z) const {
    return (uint64_t)((x * (ny + 1) + y) * (nz + 1) + z);  // unique per lattice pt
  }

  int32_t VertexOnEdge(int64_t ax, int64_t ay, int64_t az, float va,
                       int64_t bx, int64_t by, int64_t bz, float vb) {
    uint64_t key = EdgeKey(CornerId(ax, ay, az), CornerId(bx, by, bz));
    auto it = edge_cache.find(key);
    if (it != edge_cache.end()) return it->second;
    float denom = vb - va;
    float t = denom == 0.0f ? 0.5f : (level - va) / denom;
    if (t < 0.0f) t = 0.0f;
    if (t > 1.0f) t = 1.0f;
    float px = origin[0] + spacing[0] * ((float)ax + t * (float)(bx - ax));
    float py = origin[1] + spacing[1] * ((float)ay + t * (float)(by - ay));
    float pz = origin[2] + spacing[2] * ((float)az + t * (float)(bz - az));
    int32_t idx = (int32_t)(verts.size() / 3);
    verts.push_back(px);
    verts.push_back(py);
    verts.push_back(pz);
    edge_cache.emplace(key, idx);
    return idx;
  }

  void EmitTri(int32_t a, int32_t b, int32_t c) {
    if (a == b || b == c || a == c) return;  // degenerate
    faces.push_back(a);
    faces.push_back(b);
    faces.push_back(c);
  }

  void Run() {
    int64_t cx[8], cy[8], cz[8];
    float cv[8];
    for (int64_t x = 0; x + 1 < nx; ++x) {
      for (int64_t y = 0; y + 1 < ny; ++y) {
        for (int64_t z = 0; z + 1 < nz; ++z) {
          for (int c = 0; c < 8; ++c) {
            cx[c] = x + (c & 1);
            cy[c] = y + ((c >> 1) & 1);
            cz[c] = z + ((c >> 2) & 1);
            cv[c] = Value(cx[c], cy[c], cz[c]);
          }
          for (const auto& tet : kTets) {
            ProcessTet(cx, cy, cz, cv, tet);
          }
        }
      }
    }
  }

  void ProcessTet(const int64_t* cx, const int64_t* cy, const int64_t* cz,
                  const float* cv, const int tet[4]) {
    int inside = 0;
    for (int i = 0; i < 4; ++i) {
      if (cv[tet[i]] > level) inside |= (1 << i);
    }
    if (inside == 0 || inside == 15) return;

    auto edge_vert = [&](int i, int j) {
      int a = tet[i], b = tet[j];
      return VertexOnEdge(cx[a], cy[a], cz[a], cv[a],
                          cx[b], cy[b], cz[b], cv[b]);
    };

    // Orientation convention: triangles wind so normals point toward the
    // "inside > level" region being on the negative side (then flipped by
    // the caller if needed, mirroring the reference's faces[...,::-1]).
    switch (inside) {
      case 1:  EmitTri(edge_vert(0, 1), edge_vert(0, 2), edge_vert(0, 3)); break;
      case 14: EmitTri(edge_vert(0, 2), edge_vert(0, 1), edge_vert(0, 3)); break;
      case 2:  EmitTri(edge_vert(1, 0), edge_vert(1, 3), edge_vert(1, 2)); break;
      case 13: EmitTri(edge_vert(1, 3), edge_vert(1, 0), edge_vert(1, 2)); break;
      case 4:  EmitTri(edge_vert(2, 0), edge_vert(2, 1), edge_vert(2, 3)); break;
      case 11: EmitTri(edge_vert(2, 1), edge_vert(2, 0), edge_vert(2, 3)); break;
      case 8:  EmitTri(edge_vert(3, 0), edge_vert(3, 2), edge_vert(3, 1)); break;
      case 7:  EmitTri(edge_vert(3, 2), edge_vert(3, 0), edge_vert(3, 1)); break;
      case 3:  // verts 0,1 inside
        EmitTri(edge_vert(0, 2), edge_vert(0, 3), edge_vert(1, 3));
        EmitTri(edge_vert(0, 2), edge_vert(1, 3), edge_vert(1, 2));
        break;
      case 12:
        EmitTri(edge_vert(0, 3), edge_vert(0, 2), edge_vert(1, 3));
        EmitTri(edge_vert(1, 3), edge_vert(0, 2), edge_vert(1, 2));
        break;
      case 5:  // verts 0,2 inside
        EmitTri(edge_vert(0, 1), edge_vert(2, 1), edge_vert(0, 3));
        EmitTri(edge_vert(2, 1), edge_vert(2, 3), edge_vert(0, 3));
        break;
      case 10:
        EmitTri(edge_vert(2, 1), edge_vert(0, 1), edge_vert(0, 3));
        EmitTri(edge_vert(2, 3), edge_vert(2, 1), edge_vert(0, 3));
        break;
      case 6:  // verts 1,2 inside
        EmitTri(edge_vert(1, 0), edge_vert(2, 0), edge_vert(1, 3));
        EmitTri(edge_vert(2, 0), edge_vert(2, 3), edge_vert(1, 3));
        break;
      case 9:
        EmitTri(edge_vert(2, 0), edge_vert(1, 0), edge_vert(1, 3));
        EmitTri(edge_vert(2, 3), edge_vert(2, 0), edge_vert(1, 3));
        break;
    }
  }
};

}  // namespace

extern "C" {

int mesh_extract(const float* grid, int64_t nx, int64_t ny, int64_t nz,
                 float level, const float* origin, const float* spacing,
                 float** out_verts, int64_t* n_verts, int32_t** out_faces,
                 int64_t* n_faces) {
  Extractor ex;
  ex.grid = grid;
  ex.nx = nx;
  ex.ny = ny;
  ex.nz = nz;
  ex.level = level;
  ex.origin = origin;
  ex.spacing = spacing;
  ex.Run();

  *n_verts = (int64_t)(ex.verts.size() / 3);
  *n_faces = (int64_t)(ex.faces.size() / 3);
  *out_verts = (float*)std::malloc(ex.verts.size() * sizeof(float));
  *out_faces = (int32_t*)std::malloc(ex.faces.size() * sizeof(int32_t));
  if ((*out_verts == nullptr && !ex.verts.empty()) ||
      (*out_faces == nullptr && !ex.faces.empty())) {
    std::free(*out_verts);
    std::free(*out_faces);
    return -1;
  }
  std::memcpy(*out_verts, ex.verts.data(), ex.verts.size() * sizeof(float));
  std::memcpy(*out_faces, ex.faces.data(), ex.faces.size() * sizeof(int32_t));
  return 0;
}

void mesh_free(void* p) { std::free(p); }

}  // extern "C"
