// Minimal 3-D rigid-body math for the simcore.
// Replaces the reference's dependency on SAPIEN/PhysX + Pinocchio math types
// (reference env/base_sapien_env.py, env/sapien_envs/osc_planner.py) with a
// self-contained header. Quaternions are (w, x, y, z).
#pragma once

#include <cmath>
#include <cstring>
#include <algorithm>

namespace sc {

struct Vec3 {
  double x = 0, y = 0, z = 0;
  Vec3() = default;
  Vec3(double x_, double y_, double z_) : x(x_), y(y_), z(z_) {}
  Vec3 operator+(const Vec3& o) const { return {x + o.x, y + o.y, z + o.z}; }
  Vec3 operator-(const Vec3& o) const { return {x - o.x, y - o.y, z - o.z}; }
  Vec3 operator-() const { return {-x, -y, -z}; }
  Vec3 operator*(double s) const { return {x * s, y * s, z * s}; }
  Vec3& operator+=(const Vec3& o) { x += o.x; y += o.y; z += o.z; return *this; }
  double dot(const Vec3& o) const { return x * o.x + y * o.y + z * o.z; }
  Vec3 cross(const Vec3& o) const {
    return {y * o.z - z * o.y, z * o.x - x * o.z, x * o.y - y * o.x};
  }
  double norm() const { return std::sqrt(dot(*this)); }
  Vec3 normalized() const {
    double n = norm();
    return n > 1e-12 ? (*this) * (1.0 / n) : Vec3{0, 0, 0};
  }
  double operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Quat {
  double w = 1, x = 0, y = 0, z = 0;
  Quat() = default;
  Quat(double w_, double x_, double y_, double z_) : w(w_), x(x_), y(y_), z(z_) {}

  static Quat axis_angle(const Vec3& axis, double angle) {
    Vec3 a = axis.normalized();
    double h = angle * 0.5, s = std::sin(h);
    return {std::cos(h), a.x * s, a.y * s, a.z * s};
  }
  Quat operator*(const Quat& o) const {
    return {w * o.w - x * o.x - y * o.y - z * o.z,
            w * o.x + x * o.w + y * o.z - z * o.y,
            w * o.y + y * o.w + z * o.x - x * o.z,
            w * o.z + z * o.w + x * o.y - y * o.x};
  }
  Quat conj() const { return {w, -x, -y, -z}; }
  Quat normalized() const {
    double n = std::sqrt(w * w + x * x + y * y + z * z);
    if (n < 1e-12) return {1, 0, 0, 0};
    return {w / n, x / n, y / n, z / n};
  }
  Vec3 rotate(const Vec3& v) const {
    Vec3 qv{x, y, z};
    Vec3 t = qv.cross(v) * 2.0;
    return v + t * w + qv.cross(t);
  }
  // columns of the rotation matrix = images of the basis vectors
  Vec3 col(int i) const {
    switch (i) {
      case 0: return {1 - 2 * (y * y + z * z), 2 * (x * y + w * z), 2 * (x * z - w * y)};
      case 1: return {2 * (x * y - w * z), 1 - 2 * (x * x + z * z), 2 * (y * z + w * x)};
      default: return {2 * (x * z + w * y), 2 * (y * z - w * x), 1 - 2 * (x * x + y * y)};
    }
  }
};

// Quaternion from a rotation matrix given by its columns (robust 4-candidate
// construction, valid for all rotations).
inline Quat quat_from_cols(const Vec3& cx, const Vec3& cy, const Vec3& cz) {
  double m00 = cx.x, m01 = cy.x, m02 = cz.x;
  double m10 = cx.y, m11 = cy.y, m12 = cz.y;
  double m20 = cx.z, m21 = cy.z, m22 = cz.z;
  double tr = m00 + m11 + m22;
  double c0 = 1 + tr, c1 = 1 + m00 - m11 - m22, c2 = 1 + m11 - m00 - m22,
         c3 = 1 + m22 - m00 - m11;
  Quat q;
  if (c0 >= c1 && c0 >= c2 && c0 >= c3)
    q = {c0, m21 - m12, m02 - m20, m10 - m01};
  else if (c1 >= c2 && c1 >= c3)
    q = {m21 - m12, c1, m01 + m10, m02 + m20};
  else if (c2 >= c3)
    q = {m02 - m20, m01 + m10, c2, m12 + m21};
  else
    q = {m10 - m01, m02 + m20, m12 + m21, c3};
  return q.normalized();
}

struct Pose {
  Vec3 p;
  Quat q;
  Pose() = default;
  Pose(const Vec3& p_, const Quat& q_) : p(p_), q(q_) {}
  Pose operator*(const Pose& o) const { return {p + q.rotate(o.p), (q * o.q).normalized()}; }
  Pose inv() const {
    Quat qi = q.conj();
    return {qi.rotate(-p), qi};
  }
  Vec3 apply(const Vec3& v) const { return p + q.rotate(v); }
  Vec3 apply_inv(const Vec3& v) const { return q.conj().rotate(v - p); }
};

inline void pose_to7(const Pose& pose, double* out) {
  out[0] = pose.p.x; out[1] = pose.p.y; out[2] = pose.p.z;
  out[3] = pose.q.w; out[4] = pose.q.x; out[5] = pose.q.y; out[6] = pose.q.z;
}
inline Pose pose_from7(const double* v) {
  return Pose{{v[0], v[1], v[2]}, Quat{v[3], v[4], v[5], v[6]}.normalized()};
}

// Solve the 6x6 SPD-ish system (A + lambda^2 I) x = b in place (Gaussian
// elimination with partial pivoting). Used by damped-least-squares IK.
inline bool solve6(double A[6][6], double b[6], double x[6]) {
  for (int col = 0; col < 6; col++) {
    int best = col;
    for (int r = col + 1; r < 6; r++)
      if (std::fabs(A[r][col]) > std::fabs(A[best][col])) best = r;
    if (std::fabs(A[best][col]) < 1e-14) return false;
    if (best != col) {
      for (int c = 0; c < 6; c++) std::swap(A[col][c], A[best][c]);
      std::swap(b[col], b[best]);
    }
    double inv = 1.0 / A[col][col];
    for (int r = col + 1; r < 6; r++) {
      double f = A[r][col] * inv;
      if (f == 0) continue;
      for (int c = col; c < 6; c++) A[r][c] -= f * A[col][c];
      b[r] -= f * b[col];
    }
  }
  for (int r = 5; r >= 0; r--) {
    double s = b[r];
    for (int c = r + 1; c < 6; c++) s -= A[r][c] * x[c];
    x[r] = s / A[r][r];
  }
  return true;
}

}  // namespace sc
