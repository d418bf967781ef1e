// The port's native COLMAP sparse-depth path: COLMAP sparse-model parsing
// and sparse-depth splatting on the host, a copy of the JAX package's
// native/colmap_fast.cpp.
//
// ``data/base.py::load_colmap_sparse_depth`` does this work in Python per
// scene: for every image, walk its 2D observations, look up the 3D point,
// project to a depth along the camera z-axis, weight by reprojection
// error, and splat into a depth / weight image.  Here it is one pass of
// native code behind a plain C interface, loaded with ctypes by
// ``data/native.py``.
//
// Build: ``kernels/build.py::load("colmap_fast")`` compiles it with $CXX or
// g++ at first use into ucnerf_torch/_build/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Obs {
  double x, y;
  int64_t point3d_id;
};

struct ImageRec {
  int32_t image_id;
  double qvec[4];
  double tvec[3];
  std::string name;
  std::vector<Obs> obs;
};

struct PointRec {
  double xyz[3];
  double error;
};

struct Model {
  std::vector<ImageRec> images;              // sorted by name
  std::unordered_map<int64_t, PointRec> points;
  double err_mean = 0.0;
};

template <typename T>
bool read_raw(FILE* f, T* out, size_t n = 1) {
  return fread(out, sizeof(T), n, f) == n;
}

bool load_images_bin(const char* path, std::vector<ImageRec>& images) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint64_t n;
  if (!read_raw(f, &n)) { fclose(f); return false; }
  images.resize(n);
  for (uint64_t i = 0; i < n; ++i) {
    ImageRec& im = images[i];
    int32_t cam_id;
    if (!read_raw(f, &im.image_id) || !read_raw(f, im.qvec, 4) ||
        !read_raw(f, im.tvec, 3) || !read_raw(f, &cam_id)) {
      fclose(f);
      return false;
    }
    int c;
    while ((c = fgetc(f)) > 0) im.name.push_back(static_cast<char>(c));
    uint64_t npts;
    if (!read_raw(f, &npts)) { fclose(f); return false; }
    im.obs.resize(npts);
    // packed (double x, double y, int64 id) == 24 bytes, no padding
    static_assert(sizeof(Obs) == 24, "Obs must be packed");
    if (!read_raw(f, im.obs.data(), npts)) { fclose(f); return false; }
  }
  fclose(f);
  return true;
}

bool load_points_bin(const char* path,
                     std::unordered_map<int64_t, PointRec>& points,
                     double* err_mean) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint64_t n;
  if (!read_raw(f, &n)) { fclose(f); return false; }
  points.reserve(n);
  double err_sum = 0.0;
  for (uint64_t i = 0; i < n; ++i) {
    int64_t id;
    PointRec p;
    uint8_t rgb[3];
    uint64_t track_len;
    if (!read_raw(f, &id) || !read_raw(f, p.xyz, 3) || !read_raw(f, rgb, 3) ||
        !read_raw(f, &p.error) || !read_raw(f, &track_len)) {
      fclose(f);
      return false;
    }
    fseek(f, static_cast<long>(track_len) * 8, SEEK_CUR);
    err_sum += p.error;
    points.emplace(id, p);
  }
  *err_mean = n ? err_sum / static_cast<double>(n) : 1.0;
  fclose(f);
  return true;
}

}  // namespace

extern "C" {

// Opaque model handle ------------------------------------------------------
void* colmap_fast_load(const char* sparse_dir) {
  auto* m = new Model();
  std::string dir(sparse_dir);
  if (!load_images_bin((dir + "/images.bin").c_str(), m->images) ||
      !load_points_bin((dir + "/points3D.bin").c_str(), m->points,
                       &m->err_mean)) {
    delete m;
    return nullptr;
  }
  // sort by image name to match the reference's name-sorted output
  std::sort(m->images.begin(), m->images.end(),
            [](const ImageRec& a, const ImageRec& b) {
              return a.name < b.name;
            });
  return m;
}

void colmap_fast_free(void* handle) { delete static_cast<Model*>(handle); }

int colmap_fast_num_images(void* handle) {
  return static_cast<int>(static_cast<Model*>(handle)->images.size());
}

int colmap_fast_image_name(void* handle, int idx, char* out, int cap) {
  const auto& im = static_cast<Model*>(handle)->images[idx];
  int n = static_cast<int>(im.name.size());
  if (n + 1 > cap) return -1;
  memcpy(out, im.name.c_str(), n + 1);
  return n;
}

// Sparse-depth splat for one image ----------------------------------------
// Semantics match reference data/scared.py:304-335:
//   depth = c2w_z . (pt - cam_center) * sc,  rejected outside [lo, hi]*sc,
//   weight = 2*exp(-(err/err_mean)^2),
//   pixel = (int(y/factor), int(x/factor)), rejected outside the image.
// Outputs: depth_img/weight_img [h*w] (row-major), coords [max_pts*2],
// depths/weights [max_pts]; returns number of valid points.
int colmap_fast_splat(void* handle, int idx, double factor, double sc,
                      double lo, double hi, int img_w, int img_h,
                      float* depth_img, float* weight_img, int32_t* coords,
                      float* depths, float* weights, int max_pts) {
  const Model* m = static_cast<Model*>(handle);
  const ImageRec& im = m->images[idx];

  // w2c from quaternion (w, x, y, z); c2w_R = R^T, center = -R^T t
  const double w = im.qvec[0], x = im.qvec[1], y = im.qvec[2],
               z = im.qvec[3];
  double R[3][3] = {
      {1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w,
       2 * x * z + 2 * y * w},
      {2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z,
       2 * y * z - 2 * x * w},
      {2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w,
       1 - 2 * x * x - 2 * y * y}};
  double center[3];
  for (int i = 0; i < 3; ++i)
    center[i] = -(R[0][i] * im.tvec[0] + R[1][i] * im.tvec[1] +
                  R[2][i] * im.tvec[2]);
  // camera z-axis in world = R^T e_z = row 2 of R
  const double zaxis[3] = {R[2][0], R[2][1], R[2][2]};

  memset(depth_img, 0, sizeof(float) * img_w * img_h);
  memset(weight_img, 0, sizeof(float) * img_w * img_h);

  int count = 0;
  for (const Obs& ob : im.obs) {
    if (ob.point3d_id < 0) continue;
    auto it = m->points.find(ob.point3d_id);
    if (it == m->points.end()) continue;
    const PointRec& pt = it->second;
    double depth = (zaxis[0] * (pt.xyz[0] - center[0]) +
                    zaxis[1] * (pt.xyz[1] - center[1]) +
                    zaxis[2] * (pt.xyz[2] - center[2])) *
                   sc;
    if (depth < lo * sc || depth > hi * sc) continue;
    double r = pt.error / m->err_mean;
    double weight = 2.0 * std::exp(-r * r);
    int px = static_cast<int>(ob.x / factor);
    int py = static_cast<int>(ob.y / factor);
    if (px >= img_w || py >= img_h || px < 0 || py < 0) continue;
    depth_img[py * img_w + px] = static_cast<float>(depth);
    weight_img[py * img_w + px] = static_cast<float>(weight);
    if (count < max_pts) {
      coords[2 * count] = py;
      coords[2 * count + 1] = px;
      depths[count] = static_cast<float>(depth);
      weights[count] = static_cast<float>(weight);
    }
    ++count;
  }
  return count < max_pts ? count : max_pts;
}

}  // extern "C"
