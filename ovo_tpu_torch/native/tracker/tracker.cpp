// OVO-TPU host-side RGB-D tracking front-end.
//
// Replaces the reference's ORB-SLAM3 C++ dependency behind the same narrow
// binding surface (reference ovo/slam/orbslam.py:36-66):
//   process_image_rgbd (blocking) -> tracking state
//   get_last_trajectory_point     -> current camera-to-world pose
//   is_last_frame_kf              -> keyframe decision
//   get_last_big_change_idx       -> loop-closure/BA generation counter
//
// Method: dense direct RGB-D odometry. Per frame, the rigid motion relative
// to the last keyframe is estimated by coarse-to-fine Gauss-Newton over an
// image pyramid, minimizing a robust (Huber) combination of photometric and
// inverse-depth point-to-plane residuals -- the same family of alignment
// Open3D's hybrid RGB-D odometry implements (the reference's fallback
// tracker, visual_odometer.py:53-76). Self-contained: no Eigen/OpenCV,
// exposed through a plain C ABI for ctypes.
//
// Keyframes: spawned when translation/rotation to the last keyframe exceeds
// thresholds or the inlier ratio drops. Every keyframe is stored (pose + a
// small quarter/eighth-res pyramid) in a keyframe store.
//
// Loop closing (the reference tier's reason to exist -- ORB-SLAM3's
// loop-closing/GBA threads behind get_last_big_change_idx,
// reference ovo/slam/orbslam.py:62-66): when a new keyframe lands
// spatially near a much older keyframe, the two small pyramids are
// re-aligned directly; an accepted alignment yields a loop constraint whose
// error is distributed along the keyframe chain by se(3) interpolation
// (single-loop pose-graph relaxation), redundant keyframes are culled, and
// big_change_idx increments -- driving the Python side's dense-map rebuild
// and semantic loop closure exactly like ORB-SLAM3's pose-graph
// optimization does for the reference.

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Mat4 {
  double m[16];  // row-major
  static Mat4 identity() {
    Mat4 r{};
    for (int i = 0; i < 4; ++i) r.m[i * 4 + i] = 1.0;
    return r;
  }
};

Mat4 matmul(const Mat4& a, const Mat4& b) {
  Mat4 r{};
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      double s = 0;
      for (int k = 0; k < 4; ++k) s += a.m[i * 4 + k] * b.m[k * 4 + j];
      r.m[i * 4 + j] = s;
    }
  return r;
}

// Gram-Schmidt re-orthonormalization of the rotation block. The tracking
// recursion seeds each alignment with inv(cur_pose)*key_pose and composes
// the result back; inverse_rigid uses the transpose as the inverse, so any
// non-orthogonality in the chain AMPLIFIES (~5x per keyframe, measured).
// Snapping the rotation at keyframe boundaries keeps the chain rigid.
void orthonormalize(Mat4* t) {
  double r[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) r[i][j] = t->m[i * 4 + j];
  // columns: c0, c1, c2
  double n0 = std::sqrt(r[0][0] * r[0][0] + r[1][0] * r[1][0] +
                        r[2][0] * r[2][0]);
  for (int i = 0; i < 3; ++i) r[i][0] /= n0;
  double d01 = r[0][0] * r[0][1] + r[1][0] * r[1][1] + r[2][0] * r[2][1];
  for (int i = 0; i < 3; ++i) r[i][1] -= d01 * r[i][0];
  double n1 = std::sqrt(r[0][1] * r[0][1] + r[1][1] * r[1][1] +
                        r[2][1] * r[2][1]);
  for (int i = 0; i < 3; ++i) r[i][1] /= n1;
  r[0][2] = r[1][0] * r[2][1] - r[2][0] * r[1][1];
  r[1][2] = r[2][0] * r[0][1] - r[0][0] * r[2][1];
  r[2][2] = r[0][0] * r[1][1] - r[1][0] * r[0][1];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) t->m[i * 4 + j] = r[i][j];
}

Mat4 inverse_rigid(const Mat4& t) {
  Mat4 r = Mat4::identity();
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) r.m[i * 4 + j] = t.m[j * 4 + i];
  for (int i = 0; i < 3; ++i) {
    double s = 0;
    for (int j = 0; j < 3; ++j) s += r.m[i * 4 + j] * t.m[j * 4 + 3];
    r.m[i * 4 + 3] = -s;
  }
  return r;
}

// se(3) exponential map: xi = [wx, wy, wz, tx, ty, tz]
Mat4 se3_exp(const double xi[6]) {
  const double wx = xi[0], wy = xi[1], wz = xi[2];
  const double theta2 = wx * wx + wy * wy + wz * wz;
  const double theta = std::sqrt(theta2);
  double A, B, C;
  if (theta < 1e-8) {
    A = 1.0 - theta2 / 6.0;
    B = 0.5 - theta2 / 24.0;
    C = 1.0 / 6.0 - theta2 / 120.0;
  } else {
    A = std::sin(theta) / theta;
    B = (1.0 - std::cos(theta)) / theta2;
    C = (1.0 - A) / theta2;
  }
  const double W[9] = {0, -wz, wy, wz, 0, -wx, -wy, wx, 0};
  double W2[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double s = 0;
      for (int k = 0; k < 3; ++k) s += W[i * 3 + k] * W[k * 3 + j];
      W2[i * 3 + j] = s;
    }
  Mat4 T = Mat4::identity();
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double R = (i == j ? 1.0 : 0.0) + A * W[i * 3 + j] + B * W2[i * 3 + j];
      T.m[i * 4 + j] = R;
    }
  double V[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      V[i * 3 + j] = (i == j ? 1.0 : 0.0) + B * W[i * 3 + j] + C * W2[i * 3 + j];
  for (int i = 0; i < 3; ++i) {
    double s = 0;
    for (int j = 0; j < 3; ++j) s += V[i * 3 + j] * xi[3 + j];
    T.m[i * 4 + 3] = s;
  }
  return T;
}

// se(3) logarithm: inverse of se3_exp (xi = [w, t])
void se3_log(const Mat4& T, double xi[6]) {
  const double tr = T.m[0] + T.m[5] + T.m[10];
  const double cos_t = std::fmax(-1.0, std::fmin(1.0, (tr - 1.0) / 2.0));
  const double theta = std::acos(cos_t);
  double wx, wy, wz;
  if (theta < 1e-8) {
    wx = 0.5 * (T.m[9] - T.m[6]);
    wy = 0.5 * (T.m[2] - T.m[8]);
    wz = 0.5 * (T.m[4] - T.m[1]);
  } else {
    const double s = theta / (2.0 * std::sin(theta));
    wx = s * (T.m[9] - T.m[6]);
    wy = s * (T.m[2] - T.m[8]);
    wz = s * (T.m[4] - T.m[1]);
  }
  xi[0] = wx; xi[1] = wy; xi[2] = wz;
  const double theta2 = wx * wx + wy * wy + wz * wz;
  const double W[9] = {0, -wz, wy, wz, 0, -wx, -wy, wx, 0};
  double W2[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double s = 0;
      for (int k = 0; k < 3; ++k) s += W[i * 3 + k] * W[k * 3 + j];
      W2[i * 3 + j] = s;
    }
  // V^{-1} = I - W/2 + c W^2, c = (1 - A/(2B))/theta^2 (-> 1/12 at 0)
  double c;
  if (theta2 < 1e-12) {
    c = 1.0 / 12.0;
  } else {
    const double th = std::sqrt(theta2);
    const double A = std::sin(th) / th;
    const double B = (1.0 - std::cos(th)) / theta2;
    c = (1.0 - A / (2.0 * B)) / theta2;
  }
  double Vinv[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      Vinv[i * 3 + j] =
          (i == j ? 1.0 : 0.0) - 0.5 * W[i * 3 + j] + c * W2[i * 3 + j];
  for (int i = 0; i < 3; ++i) {
    double s = 0;
    for (int j = 0; j < 3; ++j) s += Vinv[i * 3 + j] * T.m[j * 4 + 3];
    xi[3 + i] = s;
  }
}

bool solve6x6(double H[36], const double g[6], double dx[6]) {
  // Cholesky with Levenberg damping already applied by the caller.
  double L[36] = {0};
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j <= i; ++j) {
      double s = H[i * 6 + j];
      for (int k = 0; k < j; ++k) s -= L[i * 6 + k] * L[j * 6 + k];
      if (i == j) {
        if (s <= 1e-12) return false;
        L[i * 6 + i] = std::sqrt(s);
      } else {
        L[i * 6 + j] = s / L[j * 6 + j];
      }
    }
  }
  double y[6];
  for (int i = 0; i < 6; ++i) {
    double s = g[i];
    for (int k = 0; k < i; ++k) s -= L[i * 6 + k] * y[k];
    y[i] = s / L[i * 6 + i];
  }
  for (int i = 5; i >= 0; --i) {
    double s = y[i];
    for (int k = i + 1; k < 6; ++k) s -= L[k * 6 + i] * dx[k];
    dx[i] = s / L[i * 6 + i];
  }
  return true;
}

struct Pyramid {
  int levels = 3;
  std::vector<std::vector<float>> gray;   // intensity [0,1]
  std::vector<std::vector<float>> depth;  // metres, 0 invalid
  std::vector<int> w, h;
  std::vector<double> fx, fy, cx, cy;

  void build(const float* g0, const float* d0, int W, int H, double fx0,
             double fy0, double cx0, double cy0) {
    gray.assign(levels, {});
    depth.assign(levels, {});
    w.assign(levels, 0);
    h.assign(levels, 0);
    fx.assign(levels, 0);
    fy.assign(levels, 0);
    cx.assign(levels, 0);
    cy.assign(levels, 0);
    gray[0].assign(g0, g0 + W * H);
    depth[0].assign(d0, d0 + W * H);
    w[0] = W;
    h[0] = H;
    fx[0] = fx0;
    fy[0] = fy0;
    cx[0] = cx0;
    cy[0] = cy0;
    for (int l = 1; l < levels; ++l) {
      int pw = w[l - 1], ph = h[l - 1];
      int nw = pw / 2, nh = ph / 2;
      w[l] = nw;
      h[l] = nh;
      fx[l] = fx[l - 1] * 0.5;
      fy[l] = fy[l - 1] * 0.5;
      cx[l] = (cx[l - 1] + 0.5) * 0.5 - 0.5;
      cy[l] = (cy[l - 1] + 0.5) * 0.5 - 0.5;
      gray[l].resize(nw * nh);
      depth[l].resize(nw * nh);
      for (int y = 0; y < nh; ++y)
        for (int x = 0; x < nw; ++x) {
          // 2x2 box filter; depth averages only valid samples
          double gs = 0, ds = 0;
          int dn = 0;
          for (int dy = 0; dy < 2; ++dy)
            for (int dxx = 0; dxx < 2; ++dxx) {
              int sx = 2 * x + dxx, sy = 2 * y + dy;
              gs += gray[l - 1][sy * pw + sx];
              float dv = depth[l - 1][sy * pw + sx];
              if (dv > 0) {
                ds += dv;
                ++dn;
              }
            }
          gray[l][y * nw + x] = static_cast<float>(gs / 4.0);
          depth[l][y * nw + x] =
              dn > 0 ? static_cast<float>(ds / dn) : 0.0f;
        }
    }
  }
};

inline bool bilerp(const std::vector<float>& img, int w, int h, double x,
                   double y, float* out) {
  if (x < 0 || y < 0 || x > w - 2 || y > h - 2) return false;
  int x0 = static_cast<int>(x), y0 = static_cast<int>(y);
  double ax = x - x0, ay = y - y0;
  float v00 = img[y0 * w + x0], v01 = img[y0 * w + x0 + 1];
  float v10 = img[(y0 + 1) * w + x0], v11 = img[(y0 + 1) * w + x0 + 1];
  *out = static_cast<float>((1 - ay) * ((1 - ax) * v00 + ax * v01) +
                            ay * ((1 - ax) * v10 + ax * v11));
  return true;
}

// A stored keyframe: pose + a small (quarter+eighth res) pyramid for
// loop-closure re-alignment. The memory cost is ~0.5 MB per keyframe at
// Replica resolution, so hundreds of keyframes fit comfortably.
struct Keyframe {
  double id = 0;           // frame id (the timestamp passed by the caller)
  Mat4 pose;               // camera-to-world
  Pyramid pyr;             // 2 levels, level 0 = quarter resolution
  bool culled = false;
  // uncertainty of the odometry step INTO this keyframe (1 - inlier
  // ratio of the tracking alignment at promotion, floored): loop-closure
  // corrections are distributed proportionally to these, so low-
  // confidence stretches absorb more of the error -- the covariance-
  // weighted essential-graph analogue of ORB-SLAM3's pose-graph
  // optimization (uniform ratios reduce to plain se(3) interpolation)
  double step_unc = 1.0;
};

struct Tracker {
  enum State { NOT_INITIALIZED = 0, OK = 2, LOST = 3 };  // ORB-SLAM3 codes

  Pyramid key;        // reference keyframe pyramid
  Mat4 key_pose;      // keyframe camera-to-world
  Mat4 cur_pose;      // current camera-to-world
  int state = NOT_INITIALIZED;
  bool last_frame_kf = false;
  int big_change_idx = 0;
  long n_frames = 0;
  std::vector<double> trajectory;  // flattened 4x4 poses

  double kf_trans_th = 0.15;   // metres
  double kf_rot_th = 0.15;     // radians (approx via axis-angle norm)
  double kf_inlier_th = 0.60;  // re-key when inlier ratio drops below

  double last_inlier_ratio = 1.0;

  // ---- loop closing state ----
  std::vector<Keyframe> kfs;
  int min_loop_kf_gap = 8;     // candidate must be this many keyframes old
  double loop_radius = 0.0;    // 0 -> derived from kf_trans_th at create()
  double loop_rot_limit = 0.8;
  double loop_inlier_th = 0.55;
  int loop_cooldown = 0;       // keyframes to skip after a closure

  // Estimate T_cur_key (camera motion from keyframe ``ref`` to frame
  // ``cur``). Returns false if alignment diverged.
  bool align(const Pyramid& ref, const Pyramid& cur, Mat4* T_ck,
             double* inlier_ratio) const {
    Mat4 T = *T_ck;  // init (zero-velocity / drifted relative estimate)
    const double huber_i = 0.07;   // photometric (intensity in [0,1])
    const double huber_d = 0.04;   // inverse-depth-ish geometric
    double final_ratio = 0.0;
    for (int l = ref.levels - 1; l >= 0; --l) {
      const int W = ref.w[l], H = ref.h[l];
      const double fx = ref.fx[l], fy = ref.fy[l];
      const double cx = ref.cx[l], cy = ref.cy[l];
      for (int it = 0; it < 10; ++it) {
        double Hm[36] = {0}, g[6] = {0};
        int n_res = 0, n_in = 0;
        const Mat4 Tinv = T;  // key->cur
        const int step = l == 0 ? 2 : 1;  // subsample full res
        for (int y = 1; y < H - 1; y += step)
          for (int x = 1; x < W - 1; x += step) {
            const float d = ref.depth[l][y * W + x];
            if (d <= 0) continue;
            // keyframe point in keyframe camera coords
            const double X = (x - cx) * d / fx;
            const double Y = (y - cy) * d / fy;
            const double Z = d;
            // transform into current camera
            const double Xc = Tinv.m[0] * X + Tinv.m[1] * Y + Tinv.m[2] * Z + Tinv.m[3];
            const double Yc = Tinv.m[4] * X + Tinv.m[5] * Y + Tinv.m[6] * Z + Tinv.m[7];
            const double Zc = Tinv.m[8] * X + Tinv.m[9] * Y + Tinv.m[10] * Z + Tinv.m[11];
            if (Zc <= 0.05) continue;
            const double u = fx * Xc / Zc + cx;
            const double v = fy * Yc / Zc + cy;
            float ic, dc;
            if (!bilerp(cur.gray[l], W, H, u, v, &ic)) continue;
            if (!bilerp(cur.depth[l], W, H, u, v, &dc) || dc <= 0) continue;
            ++n_res;
            // residuals
            const float ik = ref.gray[l][y * W + x];
            const double r_i = static_cast<double>(ic - ik);
            const double r_d = (dc - Zc);
            // gradients of current intensity
            float gx0, gx1, gy0, gy1;
            if (!bilerp(cur.gray[l], W, H, u + 1, v, &gx1) ||
                !bilerp(cur.gray[l], W, H, u - 1, v, &gx0) ||
                !bilerp(cur.gray[l], W, H, u, v + 1, &gy1) ||
                !bilerp(cur.gray[l], W, H, u, v - 1, &gy0))
              continue;
            const double gix = 0.5 * (gx1 - gx0);
            const double giy = 0.5 * (gy1 - gy0);
            // d(u,v)/d(xi) with xi = [w, t] acting on the current-camera
            // point p = (Xc, Yc, Zc):
            const double iz = 1.0 / Zc, iz2 = iz * iz;
            double Ju[6], Jv[6];
            // translation part
            Ju[3] = fx * iz;          Jv[3] = 0;
            Ju[4] = 0;                Jv[4] = fy * iz;
            Ju[5] = -fx * Xc * iz2;   Jv[5] = -fy * Yc * iz2;
            // rotation part (dp/dw = -[p]x)
            Ju[0] = -fx * Xc * Yc * iz2;            Jv[0] = -fy * (1 + Yc * Yc * iz2);
            Ju[1] = fx * (1 + Xc * Xc * iz2);       Jv[1] = fy * Xc * Yc * iz2;
            Ju[2] = -fx * Yc * iz;                  Jv[2] = fy * Xc * iz;
            // photometric jacobian
            double Ji[6];
            for (int k = 0; k < 6; ++k) Ji[k] = gix * Ju[k] + giy * Jv[k];
            // geometric jacobian: r_d = dc(u,v) - Zc
            // dZc/dxi: translation (0,0,1); rotation (Yc, -Xc, 0)... sign per dp/dw
            double Jz[6] = {Yc, -Xc, 0, 0, 0, 1};
            // (neglect the d(dc)/du terms; standard point-to-plane-ish approx)
            for (int k = 0; k < 6; ++k) Jz[k] = -Jz[k];
            // robust weights
            const double wi = std::fabs(r_i) < huber_i ? 1.0 : huber_i / std::fabs(r_i);
            const double wd = std::fabs(r_d) < huber_d ? 1.0 : huber_d / std::fabs(r_d);
            const double lam_d = 4.0;  // weight of geometric term
            if (std::fabs(r_i) < 2 * huber_i && std::fabs(r_d) < 3 * huber_d)
              ++n_in;
            for (int a = 0; a < 6; ++a) {
              g[a] -= wi * Ji[a] * r_i + lam_d * wd * Jz[a] * r_d;
              for (int b = 0; b <= a; ++b)
                Hm[a * 6 + b] += wi * Ji[a] * Ji[b] + lam_d * wd * Jz[a] * Jz[b];
            }
          }
        // sanity floor on residual count: 100 for production-size frames,
        // proportional for tiny pyramids (a 64x96 frame's eighth-res level
        // has only ~60 interior pixels; 6-DoF GN is still well-posed)
        const int need = std::min(100, std::max(24, (W * H) / 8));
        if (n_res < need) return false;
        for (int a = 0; a < 6; ++a)
          for (int b = a + 1; b < 6; ++b) Hm[a * 6 + b] = Hm[b * 6 + a];
        for (int a = 0; a < 6; ++a) Hm[a * 6 + a] *= 1.0 + 1e-3;
        double dx[6];
        if (!solve6x6(Hm, g, dx)) return false;
        T = matmul(se3_exp(dx), T);
        final_ratio = static_cast<double>(n_in) / n_res;
        double step_norm = 0;
        for (int k = 0; k < 6; ++k) step_norm += dx[k] * dx[k];
        if (step_norm < 1e-12) break;
      }
    }
    *T_ck = T;
    *inlier_ratio = final_ratio;
    return true;
  }

  // Store the just-promoted keyframe (pose + quarter/eighth-res pyramid for
  // loop re-alignment) and run loop detection + closure.
  void on_new_keyframe(const Pyramid& cur, double frame_id) {
    Keyframe kf;
    kf.id = frame_id;
    kf.pose = cur_pose;
    kf.step_unc = std::fmax(0.05, 1.0 - last_inlier_ratio);
    const int small = cur.levels - 1;  // quarter resolution
    kf.pyr.levels = 2;
    kf.pyr.build(cur.gray[small].data(), cur.depth[small].data(),
                 cur.w[small], cur.h[small], cur.fx[small], cur.fy[small],
                 cur.cx[small], cur.cy[small]);
    kfs.push_back(std::move(kf));
    if (loop_cooldown > 0) {
      --loop_cooldown;
      return;
    }
    try_close_loop();
  }

  static double pose_distance(const Mat4& a, const Mat4& b, double* rot) {
    const double dx = a.m[3] - b.m[3], dy = a.m[7] - b.m[7],
                 dz = a.m[11] - b.m[11];
    if (rot) {
      // angle of Ra^T Rb
      double tr = 0;
      for (int i = 0; i < 3; ++i)
        for (int k = 0; k < 3; ++k) tr += a.m[k * 4 + i] * b.m[k * 4 + i];
      *rot = std::acos(std::fmax(-1.0, std::fmin(1.0, (tr - 1.0) / 2.0)));
    }
    return std::sqrt(dx * dx + dy * dy + dz * dz);
  }

  // Detect a revisit of a much older keyframe, re-align the two small
  // pyramids, and distribute the closure error along the keyframe chain
  // (single-loop pose-graph relaxation by se(3) interpolation). Mirrors the
  // effect of ORB-SLAM3's loop-closing + pose-graph optimization behind
  // get_last_big_change_idx (reference ovo/slam/orbslam.py:62-66).
  void try_close_loop() {
    const int last = static_cast<int>(kfs.size()) - 1;
    if (last < min_loop_kf_gap + 1) return;
    // candidate: nearest (by drifted pose) non-culled keyframe at least
    // min_loop_kf_gap keyframes old, within the spatial/rotation gate
    int cand = -1;
    double best = loop_radius;
    for (int j = 0; j <= last - 1 - min_loop_kf_gap; ++j) {
      if (kfs[j].culled) continue;
      double rot;
      const double d = pose_distance(kfs[last].pose, kfs[j].pose, &rot);
      if (d < best && rot < loop_rot_limit) {
        best = d;
        cand = j;
      }
    }
    if (cand < 0) return;
    const bool dbg = std::getenv("OVO_TRACKER_DEBUG") != nullptr;
    if (dbg)
      std::fprintf(stderr, "[lc] cand=%d last=%d dist=%.4f\n", cand, last,
                   best);
    // re-align the two small pyramids: T maps cand-camera -> new-camera,
    // seeded from the drifted relative pose estimate
    Mat4 T = matmul(inverse_rigid(kfs[last].pose), kfs[cand].pose);
    double ratio = 0.0;
    if (!align(kfs[cand].pyr, kfs[last].pyr, &T, &ratio)) {
      if (dbg) std::fprintf(stderr, "[lc] align diverged\n");
      return;
    }
    if (dbg) std::fprintf(stderr, "[lc] align ratio=%.3f\n", ratio);
    if (ratio < loop_inlier_th) return;
    // corrected pose of the new keyframe, anchored at the (old, trusted)
    // candidate: world = cand.pose * p_cand, p_cand = T^-1 * p_new
    const Mat4 corrected = matmul(kfs[cand].pose, inverse_rigid(T));
    // world-frame correction transform and its twist
    const Mat4 E = matmul(corrected, inverse_rigid(kfs[last].pose));
    double xi[6];
    se3_log(E, xi);
    const double t_norm = std::sqrt(xi[3] * xi[3] + xi[4] * xi[4] +
                                    xi[5] * xi[5]);
    const double r_norm = std::sqrt(xi[0] * xi[0] + xi[1] * xi[1] +
                                    xi[2] * xi[2]);
    if (dbg)
      std::fprintf(stderr, "[lc] correction t=%.4f r=%.4f\n", t_norm, r_norm);
    if (t_norm < 1e-3 && r_norm < 1e-3) {
      loop_cooldown = 2;  // drift negligible: nothing to correct yet
      return;
    }
    // distribute the correction along the chain weighted by each step's
    // tracking uncertainty (1 - inlier ratio at keyframe promotion):
    // low-confidence odometry stretches absorb more of the error, the
    // newest keyframe moves by the full E. Uniform uncertainties reduce
    // to the plain se(3) interpolation.
    double total_unc = 0.0;
    for (int i = cand + 1; i <= last; ++i) total_unc += kfs[i].step_unc;
    double acc_unc = 0.0;
    for (int i = cand + 1; i <= last; ++i) {
      acc_unc += kfs[i].step_unc;
      const double a = total_unc > 0.0
          ? acc_unc / total_unc
          : static_cast<double>(i - cand) / static_cast<double>(last - cand);
      double axi[6];
      for (int k = 0; k < 6; ++k) axi[k] = a * xi[k];
      kfs[i].pose = matmul(se3_exp(axi), kfs[i].pose);
    }
    // the live tracking frame IS the newest keyframe at this point
    key_pose = kfs[last].pose;
    cur_pose = kfs[last].pose;
    cull_redundant_keyframes();
    ++big_change_idx;
    loop_cooldown = min_loop_kf_gap;
  }

  // After a closure the revisited stretch overlaps older keyframes; drop
  // keyframes whose pose is (now) redundant with an earlier surviving one,
  // like ORB-SLAM3's keyframe culling (reference orbslam.py:92-107 drops
  // pruned keyframes from the dense map).
  void cull_redundant_keyframes() {
    const int last = static_cast<int>(kfs.size()) - 1;
    for (int i = 1; i < last; ++i) {
      if (kfs[i].culled) continue;
      for (int j = 0; j < i; ++j) {
        if (kfs[j].culled) continue;
        double rot;
        const double d = pose_distance(kfs[i].pose, kfs[j].pose, &rot);
        if (d < 0.5 * kf_trans_th && rot < 0.5 * kf_rot_th) {
          kfs[i].culled = true;
          kfs[i].pyr = Pyramid();  // free the pyramid memory
          break;
        }
      }
    }
  }
};

}  // namespace

extern "C" {

void* ovo_tracker_create(double kf_trans_th, double kf_rot_th,
                         double kf_inlier_th) {
  auto* t = new Tracker();
  if (kf_trans_th > 0) t->kf_trans_th = kf_trans_th;
  if (kf_rot_th > 0) t->kf_rot_th = kf_rot_th;
  if (kf_inlier_th > 0) t->kf_inlier_th = kf_inlier_th;
  t->loop_radius = 2.5 * t->kf_trans_th;
  t->key_pose = Mat4::identity();
  t->cur_pose = Mat4::identity();
  return t;
}

void ovo_tracker_destroy(void* h) { delete static_cast<Tracker*>(h); }

// gray: HxW float [0,1]; depth: HxW float metres (0 invalid).
// Returns tracking state (ORB-SLAM3 codes: 2 = OK, 3 = LOST).
int ovo_tracker_process_image_rgbd(void* h, const float* gray,
                                   const float* depth, int w, int hgt,
                                   double fx, double fy, double cx, double cy,
                                   double timestamp) {
  auto* t = static_cast<Tracker*>(h);
  Pyramid cur;
  cur.build(gray, depth, w, hgt, fx, fy, cx, cy);
  t->last_frame_kf = false;

  if (t->state == Tracker::NOT_INITIALIZED) {
    t->key = cur;
    t->key_pose = Mat4::identity();
    t->cur_pose = Mat4::identity();
    t->state = Tracker::OK;
    t->last_frame_kf = true;
    t->big_change_idx = 0;
    t->on_new_keyframe(cur, timestamp);
  } else {
    // Seed from the last pose relative to the keyframe (zero-velocity
    // model, like Open3D's odometry seeds identity between consecutive
    // frames). A constant-velocity seed is deliberately NOT used: the
    // frame-to-KEYFRAME Gauss-Newton under-corrects near-degenerate
    // translation modes on low-structure scenes, and velocity
    // extrapolation turns that residual error into a ~3x/frame runaway
    // (reproduced on a flat synthetic scene; zero-velocity is stable).
    // The frame-to-keyframe displacement of the seed is one inter-frame
    // motion, well inside the coarse pyramid level's convergence basin.
    Mat4 T_ck = matmul(inverse_rigid(t->cur_pose), t->key_pose);
    // T_ck maps key-camera coords -> current-camera coords
    double ratio = 0.0;
    Mat4 T_est = T_ck;
    if (t->align(t->key, cur, &T_est, &ratio)) {
      t->cur_pose = matmul(t->key_pose, inverse_rigid(T_est));
      t->state = Tracker::OK;
      t->last_inlier_ratio = ratio;
      // keyframe decision: distance from keyframe
      double dx = T_est.m[3], dy = T_est.m[7], dz = T_est.m[11];
      double trans = std::sqrt(dx * dx + dy * dy + dz * dz);
      double tr = T_est.m[0] + T_est.m[5] + T_est.m[10];
      double rot = std::acos(std::fmin(1.0, std::fmax(-1.0, (tr - 1.0) / 2.0)));
      if (trans > t->kf_trans_th || rot > t->kf_rot_th ||
          ratio < t->kf_inlier_th) {
        orthonormalize(&t->cur_pose);
        t->key = cur;
        t->key_pose = t->cur_pose;
        t->last_frame_kf = true;
        t->on_new_keyframe(cur, timestamp);
      }
    } else {
      t->state = Tracker::LOST;
    }
  }
  for (int i = 0; i < 16; ++i) t->trajectory.push_back(t->cur_pose.m[i]);
  ++t->n_frames;
  return t->state;
}

int ovo_tracker_get_tracking_state(void* h) {
  return static_cast<Tracker*>(h)->state;
}

// Writes the current camera-to-world pose (row-major 4x4).
void ovo_tracker_get_last_trajectory_point(void* h, double* out16) {
  auto* t = static_cast<Tracker*>(h);
  std::memcpy(out16, t->cur_pose.m, 16 * sizeof(double));
}

int ovo_tracker_is_last_frame_kf(void* h) {
  return static_cast<Tracker*>(h)->last_frame_kf ? 1 : 0;
}

int ovo_tracker_get_last_big_change_idx(void* h) {
  return static_cast<Tracker*>(h)->big_change_idx;
}

long ovo_tracker_num_frames(void* h) {
  return static_cast<Tracker*>(h)->n_frames;
}

double ovo_tracker_last_inlier_ratio(void* h) {
  return static_cast<Tracker*>(h)->last_inlier_ratio;
}

// ---- keyframe store (consumed by the Python side's map rebuild after a
// big change, reference orbslam.py:68-115) ----

int ovo_tracker_num_keyframes(void* h) {
  return static_cast<int>(static_cast<Tracker*>(h)->kfs.size());
}

// Writes the keyframe's (possibly loop-corrected) camera-to-world pose and
// returns its frame id (the timestamp passed to process_image_rgbd).
double ovo_tracker_get_keyframe_pose(void* h, int i, double* out16) {
  auto* t = static_cast<Tracker*>(h);
  if (i < 0 || i >= static_cast<int>(t->kfs.size())) return -1.0;
  std::memcpy(out16, t->kfs[i].pose.m, 16 * sizeof(double));
  return t->kfs[i].id;
}

int ovo_tracker_keyframe_culled(void* h, int i) {
  auto* t = static_cast<Tracker*>(h);
  if (i < 0 || i >= static_cast<int>(t->kfs.size())) return 0;
  return t->kfs[i].culled ? 1 : 0;
}

// Tune loop-closure gates (tests use tighter/looser settings than the
// defaults derived from the keyframe thresholds). Non-positive = keep.
void ovo_tracker_set_loop_params(void* h, int min_kf_gap, double radius,
                                 double rot_limit, double inlier_th) {
  auto* t = static_cast<Tracker*>(h);
  if (min_kf_gap > 0) t->min_loop_kf_gap = min_kf_gap;
  if (radius > 0) t->loop_radius = radius;
  if (rot_limit > 0) t->loop_rot_limit = rot_limit;
  if (inlier_th > 0) t->loop_inlier_th = inlier_th;
}

void ovo_tracker_shutdown(void* h) { (void)h; }

}  // extern "C"
