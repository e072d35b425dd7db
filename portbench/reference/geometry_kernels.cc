// Frozen copy of the port's C++ geometry kernels
// (graphcast_tpu_torch/native/geometry_kernels.cc), built by
// portbench/reference/geometry.py with the same compiler flags, so that the
// reference's mesh2grid edges resolve triangle-containment ties as the
// port's do on the same machine.
//
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Vec3 {
  double x, y, z;
};

inline Vec3 cross(const Vec3& a, const Vec3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

inline double dot(const Vec3& a, const Vec3& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

inline double norm(const Vec3& a) { return std::sqrt(dot(a, a)); }

// Uniform bucket grid over the unit sphere keyed by (lat band, lon band).
class SphereBuckets {
 public:
  SphereBuckets(int n_lat, int n_lon) : n_lat_(n_lat), n_lon_(n_lon) {
    buckets_.resize(static_cast<size_t>(n_lat) * n_lon);
  }

  int bucket_of(const Vec3& p) const {
    double lat = std::asin(std::fmax(-1.0, std::fmin(1.0, p.z)));
    double lon = std::atan2(p.y, p.x);
    int i = static_cast<int>((lat + M_PI_2) / M_PI * n_lat_);
    int j = static_cast<int>((lon + M_PI) / (2 * M_PI) * n_lon_);
    if (i >= n_lat_) i = n_lat_ - 1;
    if (i < 0) i = 0;
    j = ((j % n_lon_) + n_lon_) % n_lon_;
    return i * n_lon_ + j;
  }

  void insert(const Vec3& p, int32_t id) {
    buckets_[bucket_of(p)].push_back(id);
  }

  // Visit all buckets intersecting the spherical cap around p of angular
  // radius `ang` (plus margin).
  template <typename Fn>
  void visit_near(const Vec3& p, double ang, Fn&& fn) const {
    double lat = std::asin(std::fmax(-1.0, std::fmin(1.0, p.z)));
    double lon = std::atan2(p.y, p.x);
    double dlat = M_PI / n_lat_;
    double dlon = 2 * M_PI / n_lon_;
    int di = static_cast<int>(ang / dlat) + 1;
    int i0 = static_cast<int>((lat + M_PI_2) / M_PI * n_lat_);
    for (int i = i0 - di; i <= i0 + di; ++i) {
      if (i < 0 || i >= n_lat_) continue;
      // Longitude span widens towards the poles.
      double band_lat = std::fmax(
          std::fabs((i + 0.0) * dlat - M_PI_2),
          std::fabs((i + 1.0) * dlat - M_PI_2));
      double cos_band = std::cos(std::fmin(band_lat, M_PI_2 - 1e-9));
      int dj;
      if (cos_band < 1e-6) {
        dj = n_lon_;  // pole band: all longitudes
      } else {
        dj = static_cast<int>(ang / (dlon * cos_band)) + 1;
        if (dj > n_lon_) dj = n_lon_;
      }
      int j0 = static_cast<int>((lon + M_PI) / (2 * M_PI) * n_lon_);
      // Clamp the wrapped window so each bucket is visited at most once.
      int j_lo = j0 - dj, j_hi = j0 + dj;
      if (j_hi - j_lo + 1 >= n_lon_) {
        j_lo = 0;
        j_hi = n_lon_ - 1;
      }
      for (int j = j_lo; j <= j_hi; ++j) {
        int jw = ((j % n_lon_) + n_lon_) % n_lon_;
        for (int32_t id : buckets_[static_cast<size_t>(i) * n_lon_ + jw]) {
          fn(id);
        }
      }
    }
  }

 private:
  int n_lat_, n_lon_;
  std::vector<std::vector<int32_t>> buckets_;
};

}  // namespace

extern "C" {

// Counts and fills (grid_idx, mesh_idx) pairs with |g - m| <= radius.
// Two-phase: call with out_* null to get the count, then again to fill.
int64_t radius_query(const double* grid_pos, int64_t n_grid,
                     const double* mesh_pos, int64_t n_mesh,
                     double radius,
                     int32_t* out_grid, int32_t* out_mesh,
                     int64_t capacity) {
  // Angular radius of the chord `radius` (chord = 2 sin(theta/2)).
  double ang = 2.0 * std::asin(std::fmin(1.0, radius / 2.0));
  int n_lat = static_cast<int>(M_PI / (ang + 1e-9));
  if (n_lat < 4) n_lat = 4;
  if (n_lat > 512) n_lat = 512;
  int n_lon = 2 * n_lat;
  SphereBuckets buckets(n_lat, n_lon);
  for (int64_t m = 0; m < n_mesh; ++m) {
    buckets.insert({mesh_pos[3 * m], mesh_pos[3 * m + 1],
                    mesh_pos[3 * m + 2]}, static_cast<int32_t>(m));
  }
  double r2 = radius * radius;
  int64_t count = 0;
  for (int64_t g = 0; g < n_grid; ++g) {
    Vec3 p{grid_pos[3 * g], grid_pos[3 * g + 1], grid_pos[3 * g + 2]};
    buckets.visit_near(p, ang, [&](int32_t m) {
      double dx = p.x - mesh_pos[3 * m];
      double dy = p.y - mesh_pos[3 * m + 1];
      double dz = p.z - mesh_pos[3 * m + 2];
      if (dx * dx + dy * dy + dz * dz <= r2) {
        if (out_grid != nullptr && count < capacity) {
          out_grid[count] = static_cast<int32_t>(g);
          out_mesh[count] = static_cast<int32_t>(m);
        }
        ++count;
      }
    });
  }
  return count;
}

// For each unit-norm point, the index of the (CCW, outward) face whose
// spherical triangle contains it: maximize min edge-plane margin.
void containing_triangles(const double* points, int64_t n_points,
                          const double* vertices, int64_t n_vertices,
                          const int32_t* faces, int64_t n_faces,
                          int32_t* out_face) {
  (void)n_vertices;
  // Bucket faces by centroid; search radius = max face circumradius.
  std::vector<Vec3> centroids(n_faces);
  double max_circum = 0.0;
  for (int64_t f = 0; f < n_faces; ++f) {
    Vec3 c{0, 0, 0};
    for (int k = 0; k < 3; ++k) {
      const double* v = vertices + 3 * faces[3 * f + k];
      c.x += v[0]; c.y += v[1]; c.z += v[2];
    }
    double n = norm(c);
    c.x /= n; c.y /= n; c.z /= n;
    centroids[f] = c;
    for (int k = 0; k < 3; ++k) {
      const double* v = vertices + 3 * faces[3 * f + k];
      Vec3 d{v[0] - c.x, v[1] - c.y, v[2] - c.z};
      double r = norm(d);
      if (r > max_circum) max_circum = r;
    }
  }
  double ang = 2.0 * std::asin(std::fmin(1.0, max_circum / 2.0)) * 1.5 + 1e-6;
  int n_lat = static_cast<int>(M_PI / ang);
  if (n_lat < 4) n_lat = 4;
  if (n_lat > 512) n_lat = 512;
  SphereBuckets buckets(n_lat, 2 * n_lat);
  for (int64_t f = 0; f < n_faces; ++f) {
    buckets.insert(centroids[f], static_cast<int32_t>(f));
  }

  for (int64_t i = 0; i < n_points; ++i) {
    Vec3 p{points[3 * i], points[3 * i + 1], points[3 * i + 2]};
    double best = -1e30;
    int32_t best_face = 0;
    bool found = false;
    buckets.visit_near(p, ang, [&](int32_t f) {
      const double* v0 = vertices + 3 * faces[3 * f + 0];
      const double* v1 = vertices + 3 * faces[3 * f + 1];
      const double* v2 = vertices + 3 * faces[3 * f + 2];
      Vec3 a{v0[0], v0[1], v0[2]}, b{v1[0], v1[1], v1[2]},
          c{v2[0], v2[1], v2[2]};
      double m0 = dot(cross(a, b), p);
      double m1 = dot(cross(b, c), p);
      double m2 = dot(cross(c, a), p);
      double mm = std::fmin(m0, std::fmin(m1, m2));
      if (mm > best) {
        best = mm;
        best_face = f;
        found = true;
      }
    });
    if (!found || best < -1e-9) {
      // Fallback: full scan (numerically degenerate or sparse buckets).
      for (int64_t f = 0; f < n_faces; ++f) {
        const double* v0 = vertices + 3 * faces[3 * f + 0];
        const double* v1 = vertices + 3 * faces[3 * f + 1];
        const double* v2 = vertices + 3 * faces[3 * f + 2];
        Vec3 a{v0[0], v0[1], v0[2]}, b{v1[0], v1[1], v1[2]},
            c{v2[0], v2[1], v2[2]};
        double mm = std::fmin(dot(cross(a, b), p),
                              std::fmin(dot(cross(b, c), p),
                                        dot(cross(c, a), p)));
        if (mm > best) {
          best = mm;
          best_face = static_cast<int32_t>(f);
        }
      }
    }
    out_face[i] = best_face;
  }
}

}  // extern "C"
