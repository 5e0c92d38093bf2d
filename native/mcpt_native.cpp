// Native host runtime for montecarlopathtracer.
//
// The reference's host runtime is C++ (its OBJ/MTL parser at
// CVMCTracer/CVMCTracer/Framework/ObjReader.{hpp,cpp} and its KD-tree
// builder at MCRT/QuinEngine/Utils/KDTree.hpp). This library is the
// framework's native equivalent of those two components: a scene loader
// and an acceleration-structure builder that produce exactly the flat
// arrays the JAX device layer consumes. Semantics match the Python
// fallbacks in scene/objio.py and accel/kdtree.py bit-for-bit (the
// Python versions remain the portable oracle; tests assert agreement).
//
// Exposed as a plain C ABI consumed via ctypes — no pybind11 dependency.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC mcpt_native.cpp -o libmcpt_native.so

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fstream>
#include <limits>
#include <memory>
#include <sstream>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// OBJ/MTL parser
// ---------------------------------------------------------------------------
// Behavioral contract (same as scene/objio.py, derived from the
// reference parser's observable behavior):
//  - index 0 of vertex/texture/normal/triangle pools is a dummy entry so
//    1-based OBJ indices index directly (ObjReader.hpp:40-54);
//  - faces with >3 vertices fan-triangulate as (v0, v_{i-1}, v_i)
//    (ObjReader.cpp:90-104);
//  - backslash line continuations join lines (ObjReader.cpp:28-33);
//  - a `Ks` line force-sets Ns=2, later `Ns` overrides
//    (ObjReader.cpp:225-233);
//  - material slot 0 is an unnamed default; unknown `usemtl` resolves to
//    it; lookup scans from slot 1 (ObjReader.hpp:78-88);
//  - `g` switches the active group; groups accumulate triangle ids.

struct Material {
  std::string name;
  double ka[3] = {0., 0., 0.};
  double kd[3] = {0., 0., 0.};
  double ks[3] = {0., 0., 0.};
  double ns = 1.;
  double tr = 0.;
  double ni = 1.;
};

struct Triangle {
  int32_t v[3] = {0, 0, 0};
  int32_t t[3] = {0, 0, 0};
  int32_t n[3] = {0, 0, 0};
  int32_t material = 0;
};

struct Model {
  // Pools are double so parsed literals match Python's float() exactly
  // (the device layer casts to f32 at ScenePack build, same as the
  // Python loader's vertex_array()).
  std::vector<double> vertices;  // 3 per entry, entry 0 dummy
  std::vector<double> textures;  // 2 per entry, entry 0 dummy
  std::vector<double> normals;   // 3 per entry, entry 0 dummy
  std::vector<Triangle> triangles;  // entry 0 dummy
  std::vector<Material> materials;  // entry 0 unnamed default
  std::vector<std::string> group_names;      // insertion order
  std::vector<std::vector<int32_t>> groups;  // triangle ids per group
  std::string error;
};

// Read lines with backslash continuations joined; handles \n and \r\n.
class LogicalLineReader {
 public:
  explicit LogicalLineReader(std::istream& in) : in_(in) {}
  bool next(std::string& out) {
    out.clear();
    std::string raw;
    while (std::getline(in_, raw)) {
      while (!raw.empty() && (raw.back() == '\r' || raw.back() == '\n'))
        raw.pop_back();
      if (!raw.empty() && raw.back() == '\\') {
        out += raw.substr(0, raw.size() - 1);
        continue;
      }
      out += raw;
      return true;
    }
    return !out.empty();
  }

 private:
  std::istream& in_;
};

std::vector<std::string> tokenize(const std::string& line) {
  std::vector<std::string> toks;
  std::istringstream ss(line);
  std::string t;
  while (ss >> t) toks.push_back(std::move(t));
  return toks;
}

int find_material(const Model& m, const std::string& name) {
  for (size_t i = 1; i < m.materials.size(); ++i)
    if (m.materials[i].name == name) return static_cast<int>(i);
  return 0;
}

int group_index(Model& m, const std::string& name) {
  for (size_t i = 0; i < m.group_names.size(); ++i)
    if (m.group_names[i] == name) return static_cast<int>(i);
  m.group_names.push_back(name);
  m.groups.emplace_back();
  return static_cast<int>(m.group_names.size() - 1);
}

void parse_floats(const std::vector<std::string>& toks, double* out, int n) {
  for (int i = 0; i < n; ++i)
    out[i] = (i + 1 < static_cast<int>(toks.size()))
                 ? std::strtod(toks[i + 1].c_str(), nullptr)
                 : 0.;
}

// Parse one face-vertex token: v, v/t, v//n or v/t/n. Missing → 0.
void parse_face_vertex(const std::string& tok, int32_t out[3]) {
  out[0] = out[1] = out[2] = 0;
  size_t s1 = tok.find('/');
  if (s1 == std::string::npos) {
    out[0] = std::atoi(tok.c_str());
    return;
  }
  out[0] = std::atoi(tok.substr(0, s1).c_str());
  size_t s2 = tok.find('/', s1 + 1);
  if (s2 == std::string::npos) {
    std::string t = tok.substr(s1 + 1);
    out[1] = t.empty() ? 0 : std::atoi(t.c_str());
    return;
  }
  std::string t = tok.substr(s1 + 1, s2 - s1 - 1);
  std::string n = tok.substr(s2 + 1);
  out[1] = t.empty() ? 0 : std::atoi(t.c_str());
  out[2] = n.empty() ? 0 : std::atoi(n.c_str());
}

bool read_mtl(Model& m, const std::string& path) {
  std::ifstream f(path);
  if (!f) {
    m.error = "cannot open mtl: " + path;
    return false;
  }
  LogicalLineReader lines(f);
  std::string line;
  int idx = 0;
  while (lines.next(line)) {
    auto toks = tokenize(line);
    if (toks.empty() || toks[0][0] == '#') continue;
    const std::string& key = toks[0];
    if (key == "newmtl") {
      std::string name = toks.size() > 1 ? toks[1] : "";
      idx = find_material(m, name);
      if (idx == 0) {
        Material mat;
        mat.name = name;
        m.materials.push_back(std::move(mat));
        idx = static_cast<int>(m.materials.size() - 1);
      }
    } else if (key == "Ka") {
      parse_floats(toks, m.materials[idx].ka, 3);
    } else if (key == "Kd") {
      parse_floats(toks, m.materials[idx].kd, 3);
    } else if (key == "Ks") {
      parse_floats(toks, m.materials[idx].ks, 3);
      // Reference quirk: Ks implies specular classification
      // (ObjReader.cpp:225-233); a later Ns line overrides.
      m.materials[idx].ns = 2.;
    } else if (key == "Ns") {
      m.materials[idx].ns =
          toks.size() > 1 ? std::strtod(toks[1].c_str(), nullptr) : 1.;
    } else if (key == "Tr") {
      m.materials[idx].tr =
          toks.size() > 1 ? std::strtod(toks[1].c_str(), nullptr) : 0.;
    } else if (key == "Ni") {
      m.materials[idx].ni =
          toks.size() > 1 ? std::strtod(toks[1].c_str(), nullptr) : 1.;
    }
  }
  return true;
}

std::string dirname_of(const std::string& path) {
  size_t p = path.find_last_of("/\\");
  return p == std::string::npos ? std::string() : path.substr(0, p + 1);
}

std::unique_ptr<Model> read_obj(const std::string& path) {
  auto m = std::make_unique<Model>();
  // Dummy slot 0 in every pool.
  m->vertices.assign(3, 0.);
  m->textures.assign(2, 0.);
  m->normals.assign(3, 0.);
  m->triangles.emplace_back();
  m->materials.emplace_back();  // unnamed default

  std::ifstream f(path);
  if (!f) {
    m->error = "cannot open obj: " + path;
    return m;
  }
  int group = group_index(*m, "default");
  int material = 0;

  LogicalLineReader lines(f);
  std::string line;
  while (lines.next(line)) {
    auto toks = tokenize(line);
    if (toks.empty() || toks[0][0] == '#') continue;
    const std::string& key = toks[0];
    if (key == "mtllib") {
      if (toks.size() > 1) {
        if (!read_mtl(*m, dirname_of(path) + toks[1])) return m;
      }
    } else if (key == "g") {
      group = group_index(*m, toks.size() > 1 ? toks[1] : "default");
    } else if (key == "usemtl") {
      material = toks.size() > 1 ? find_material(*m, toks[1]) : 0;
    } else if (key == "v") {
      double p[3];
      parse_floats(toks, p, 3);
      m->vertices.insert(m->vertices.end(), p, p + 3);
    } else if (key == "vt") {
      double p[2];
      parse_floats(toks, p, 2);
      m->textures.insert(m->textures.end(), p, p + 2);
    } else if (key == "vn") {
      double p[3];
      parse_floats(toks, p, 3);
      m->normals.insert(m->normals.end(), p, p + 3);
    } else if (key == "f") {
      // Fan triangulation (ObjReader.cpp:90-104).
      std::vector<int32_t> fv;
      fv.reserve((toks.size() - 1) * 3);
      for (size_t i = 1; i < toks.size(); ++i) {
        int32_t vtn[3];
        parse_face_vertex(toks[i], vtn);
        fv.insert(fv.end(), vtn, vtn + 3);
      }
      size_t nfv = fv.size() / 3;
      for (size_t i = 2; i < nfv; ++i) {
        Triangle tri;
        tri.v[0] = fv[0 * 3 + 0];
        tri.v[1] = fv[(i - 1) * 3 + 0];
        tri.v[2] = fv[i * 3 + 0];
        tri.t[0] = fv[0 * 3 + 1];
        tri.t[1] = fv[(i - 1) * 3 + 1];
        tri.t[2] = fv[i * 3 + 1];
        tri.n[0] = fv[0 * 3 + 2];
        tri.n[1] = fv[(i - 1) * 3 + 2];
        tri.n[2] = fv[i * 3 + 2];
        tri.material = material;
        m->triangles.push_back(tri);
        m->groups[group].push_back(
            static_cast<int32_t>(m->triangles.size() - 1));
      }
    }
  }
  return m;
}

// ---------------------------------------------------------------------------
// KD-tree builder
// ---------------------------------------------------------------------------
// Build policy (same as accel/kdtree.py, derived from the reference's
// MCRT/QuinEngine/Utils/KDTree.hpp:55-402):
//  - BFS construction, depth cap 32;
//  - nodes with > 64 triangles: spatial median split on the longest
//    AABB axis;
//  - nodes with <= 64 triangles: exact SAH sweep over all triangle
//    vertex coordinates as candidate planes, cost (AL*nL + AR*nR)/A0,
//    split only when it beats leaf cost numTri;
//  - straddling triangles are duplicated into both children; a triangle
//    lying flat on the split plane goes left;
//  - child AABBs clip to the union of contained triangle AABBs.
// All arithmetic in double, matching the Python builder (which promotes
// vertices to float64), so both produce identical trees.

constexpr int kLeafMax = 64;   // KDTree.hpp:108
constexpr int kDepthCap = 32;  // KDTree.hpp:103

struct KDNode {
  double lo[3], hi[3];
  std::vector<int32_t> tri_ids;
  int axis = -1;  // -1 = leaf
  double value = 0.0;
  int left = -1, right = -1;  // indices into the node pool
};

struct KDTreeBuild {
  std::vector<KDNode> nodes;  // node 0 = root
  // Flat pre-order + skip-link layout (filled by flatten()).
  std::vector<float> node_lo, node_hi;  // 3 per node
  std::vector<int32_t> node_skip, leaf_start, leaf_count, leaf_tris;
};

struct Soup {
  const float *a, *b, *c;  // [T, 3] each
  std::vector<double> tlo, thi;  // per-triangle AABB, 3 per entry
  int64_t T;

  double vert(int corner, int64_t t, int axis) const {
    const float* p = corner == 0 ? a : (corner == 1 ? b : c);
    return static_cast<double>(p[t * 3 + axis]);
  }
};

double half_area(const double lo[3], const double hi[3]) {
  double d[3];
  for (int i = 0; i < 3; ++i) d[i] = std::max(hi[i] - lo[i], 0.0);
  return d[0] * d[1] + d[1] * d[2] + d[2] * d[0];
}

// Reference distribution rule (KDTree.hpp:129-153): flat-on-plane →
// left only; else min < value → left, max > value → right.
void partition(const Soup& s, const std::vector<int32_t>& ids, int axis,
               double value, std::vector<int32_t>& left,
               std::vector<int32_t>& right) {
  left.clear();
  right.clear();
  for (int32_t t : ids) {
    double lo = s.tlo[t * 3 + axis], hi = s.thi[t * 3 + axis];
    bool flat_on = (lo == hi) && (lo == value);
    if (flat_on || lo < value) left.push_back(t);
    if (!flat_on && hi > value) right.push_back(t);
  }
}

// Intersect a node box with the union of the given triangles' boxes.
void clip_union(const Soup& s, const std::vector<int32_t>& ids,
                double lo[3], double hi[3]) {
  if (ids.empty()) return;
  double ulo[3] = {std::numeric_limits<double>::infinity(),
                   std::numeric_limits<double>::infinity(),
                   std::numeric_limits<double>::infinity()};
  double uhi[3] = {-ulo[0], -ulo[1], -ulo[2]};
  for (int32_t t : ids)
    for (int i = 0; i < 3; ++i) {
      ulo[i] = std::min(ulo[i], s.tlo[t * 3 + i]);
      uhi[i] = std::max(uhi[i], s.thi[t * 3 + i]);
    }
  for (int i = 0; i < 3; ++i) {
    lo[i] = std::max(lo[i], ulo[i]);
    hi[i] = std::min(hi[i], uhi[i]);
  }
}

// Exact SAH sweep over triangle-vertex candidate planes
// (KDTree.hpp:163-240). Returns true and fills (axis, value) on split.
bool sah_split(const Soup& s, const KDNode& node, int* out_axis,
               double* out_value) {
  const auto& ids = node.tri_ids;
  int64_t n = static_cast<int64_t>(ids.size());
  if (n == 0) return false;
  double a0 = half_area(node.lo, node.hi);
  if (a0 <= 0.0) return false;
  double sah_leaf = static_cast<double>(n);
  double best_sah = std::numeric_limits<double>::infinity();
  int best_axis = -1;
  double best_value = 0.0;
  std::vector<int32_t> l_ids, r_ids;
  std::vector<double> cands;
  for (int axis = 0; axis < 3; ++axis) {
    cands.clear();
    for (int corner = 0; corner < 3; ++corner)
      for (int32_t t : ids) cands.push_back(s.vert(corner, t, axis));
    std::sort(cands.begin(), cands.end());
    cands.erase(std::unique(cands.begin(), cands.end()), cands.end());
    for (double value : cands) {
      if (value < node.lo[axis] || value > node.hi[axis]) continue;
      partition(s, ids, axis, value, l_ids, r_ids);
      double al = 0.0, ar = 0.0;
      if (!l_ids.empty()) {
        double lo[3] = {node.lo[0], node.lo[1], node.lo[2]};
        double hi[3] = {node.hi[0], node.hi[1], node.hi[2]};
        hi[axis] = value;
        clip_union(s, l_ids, lo, hi);
        al = half_area(lo, hi);
      }
      if (!r_ids.empty()) {
        double lo[3] = {node.lo[0], node.lo[1], node.lo[2]};
        double hi[3] = {node.hi[0], node.hi[1], node.hi[2]};
        lo[axis] = value;
        clip_union(s, r_ids, lo, hi);
        ar = half_area(lo, hi);
      }
      double sah =
          (al * static_cast<double>(l_ids.size()) +
           ar * static_cast<double>(r_ids.size())) / a0;
      if (sah < best_sah) {
        best_sah = sah;
        best_axis = axis;
        best_value = value;
      }
    }
  }
  if (best_axis >= 0 && best_sah < sah_leaf) {
    *out_axis = best_axis;
    *out_value = best_value;
    return true;
  }
  return false;
}

std::unique_ptr<KDTreeBuild> build_kdtree(const float* a, const float* b,
                                          const float* c,
                                          const uint8_t* valid, int64_t T) {
  auto out = std::make_unique<KDTreeBuild>();
  Soup s{a, b, c, {}, {}, T};
  s.tlo.resize(T * 3);
  s.thi.resize(T * 3);
  for (int64_t t = 0; t < T; ++t)
    for (int i = 0; i < 3; ++i) {
      double va = s.vert(0, t, i), vb = s.vert(1, t, i), vc = s.vert(2, t, i);
      s.tlo[t * 3 + i] = std::min(std::min(va, vb), vc);
      s.thi[t * 3 + i] = std::max(std::max(va, vb), vc);
    }

  KDNode root;
  for (int i = 0; i < 3; ++i) {
    root.lo[i] = 0.0;
    root.hi[i] = 0.0;
  }
  bool first = true;
  for (int64_t t = 0; t < T; ++t) {
    if (valid && !valid[t]) continue;
    root.tri_ids.push_back(static_cast<int32_t>(t));
    for (int i = 0; i < 3; ++i) {
      if (first) {
        root.lo[i] = s.tlo[t * 3 + i];
        root.hi[i] = s.thi[t * 3 + i];
      } else {
        root.lo[i] = std::min(root.lo[i], s.tlo[t * 3 + i]);
        root.hi[i] = std::max(root.hi[i], s.thi[t * 3 + i]);
      }
    }
    if (first) first = false;
  }
  out->nodes.push_back(std::move(root));

  // BFS work list, same order as the Python builder.
  std::deque<std::pair<int, int>> work;  // (node index, depth)
  work.emplace_back(0, 0);
  std::vector<int32_t> l_ids, r_ids;
  while (!work.empty()) {
    auto [ni, depth] = work.front();
    work.pop_front();
    if (depth >= kDepthCap) continue;
    int axis;
    double value;
    {
      KDNode& node = out->nodes[ni];
      int64_t n = static_cast<int64_t>(node.tri_ids.size());
      if (n > kLeafMax) {
        // Large node: spatial median on the longest axis.
        double size[3] = {node.hi[0] - node.lo[0], node.hi[1] - node.lo[1],
                          node.hi[2] - node.lo[2]};
        axis = 0;
        if (size[1] > size[axis]) axis = 1;
        if (size[2] > size[axis]) axis = 2;
        value = 0.5 * (node.hi[axis] + node.lo[axis]);
      } else {
        if (!sah_split(s, node, &axis, &value)) continue;
      }
      partition(s, node.tri_ids, axis, value, l_ids, r_ids);
    }
    KDNode left, right;
    {
      KDNode& node = out->nodes[ni];
      for (int i = 0; i < 3; ++i) {
        left.lo[i] = node.lo[i];
        left.hi[i] = node.hi[i];
        right.lo[i] = node.lo[i];
        right.hi[i] = node.hi[i];
      }
      left.hi[axis] = value;
      right.lo[axis] = value;
      clip_union(s, l_ids, left.lo, left.hi);
      clip_union(s, r_ids, right.lo, right.hi);
      left.tri_ids = l_ids;
      right.tri_ids = r_ids;
      node.axis = axis;
      node.value = value;
      node.tri_ids.clear();
      node.tri_ids.shrink_to_fit();
    }
    int li = static_cast<int>(out->nodes.size());
    out->nodes.push_back(std::move(left));  // may invalidate `node`
    int ri = static_cast<int>(out->nodes.size());
    out->nodes.push_back(std::move(right));
    out->nodes[ni].left = li;
    out->nodes[ni].right = ri;
    work.emplace_back(li, depth + 1);
    work.emplace_back(ri, depth + 1);
  }

  // Flatten: pre-order emission with skip links, CSR leaf triangles
  // (iterative; the tree can be 32 deep with big fan-out).
  struct Frame {
    int node;
    int emitted_idx;  // index in the flat arrays, -1 before emission
  };
  std::vector<std::pair<int, int>> stack;  // (node, phase 0=emit 1=patch)
  stack.emplace_back(0, 0);
  std::vector<int32_t> flat_of_node(out->nodes.size(), -1);
  while (!stack.empty()) {
    auto [ni, phase] = stack.back();
    stack.pop_back();
    KDNode& node = out->nodes[ni];
    if (phase == 0) {
      int32_t idx = static_cast<int32_t>(out->node_skip.size());
      flat_of_node[ni] = idx;
      for (int i = 0; i < 3; ++i) {
        out->node_lo.push_back(static_cast<float>(node.lo[i]));
        out->node_hi.push_back(static_cast<float>(node.hi[i]));
      }
      out->node_skip.push_back(-1);
      if (node.axis < 0) {
        out->leaf_start.push_back(
            static_cast<int32_t>(out->leaf_tris.size()));
        out->leaf_count.push_back(
            static_cast<int32_t>(node.tri_ids.size()));
        out->leaf_tris.insert(out->leaf_tris.end(), node.tri_ids.begin(),
                              node.tri_ids.end());
        out->node_skip[idx] = idx + 1;
      } else {
        out->leaf_start.push_back(0);
        out->leaf_count.push_back(0);
        stack.emplace_back(ni, 1);         // patch after subtree
        stack.emplace_back(node.right, 0); // emitted second
        stack.emplace_back(node.left, 0);  // emitted first (pre-order)
      }
    } else {
      out->node_skip[flat_of_node[ni]] =
          static_cast<int32_t>(out->node_skip.size());
    }
  }
  return out;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// ---- OBJ parser -----------------------------------------------------------

void* mcpt_obj_read(const char* path) {
  return read_obj(path).release();
}

const char* mcpt_obj_error(void* handle) {
  auto* m = static_cast<Model*>(handle);
  return m->error.empty() ? nullptr : m->error.c_str();
}

// Pool sizes (including the dummy 0 entries, matching the Python model).
void mcpt_obj_counts(void* handle, int64_t* nv, int64_t* nt, int64_t* nn,
                     int64_t* ntri, int64_t* nmat, int64_t* ngroups,
                     int64_t* group_tri_total, int64_t* name_bytes) {
  auto* m = static_cast<Model*>(handle);
  *nv = static_cast<int64_t>(m->vertices.size() / 3);
  *nt = static_cast<int64_t>(m->textures.size() / 2);
  *nn = static_cast<int64_t>(m->normals.size() / 3);
  *ntri = static_cast<int64_t>(m->triangles.size());
  *nmat = static_cast<int64_t>(m->materials.size());
  *ngroups = static_cast<int64_t>(m->group_names.size());
  int64_t total = 0;
  for (const auto& g : m->groups) total += static_cast<int64_t>(g.size());
  *group_tri_total = total;
  int64_t nb = 0;
  for (const auto& name : m->group_names) nb += name.size() + 1;
  for (const auto& mat : m->materials) nb += mat.name.size() + 1;
  *name_bytes = nb;
}

// Fill caller-allocated arrays (shapes from mcpt_obj_counts).
//  vertices f32[nv*3], textures f32[nt*2], normals f32[nn*3],
//  tri_v/tri_t/tri_n i32[ntri*3], tri_mat i32[ntri],
//  mat_* per-material fields,
//  group_start i64[ngroups+1] CSR offsets, group_tris i32[total],
//  names: group names then material names, NUL-separated.
void mcpt_obj_fill(void* handle, double* vertices, double* textures,
                   double* normals, int32_t* tri_v, int32_t* tri_t,
                   int32_t* tri_n, int32_t* tri_mat, double* mat_ka,
                   double* mat_kd, double* mat_ks, double* mat_ns,
                   double* mat_tr, double* mat_ni, int64_t* group_start,
                   int32_t* group_tris, char* names) {
  auto* m = static_cast<Model*>(handle);
  std::memcpy(vertices, m->vertices.data(),
              m->vertices.size() * sizeof(double));
  std::memcpy(textures, m->textures.data(),
              m->textures.size() * sizeof(double));
  std::memcpy(normals, m->normals.data(),
              m->normals.size() * sizeof(double));
  for (size_t i = 0; i < m->triangles.size(); ++i) {
    const Triangle& t = m->triangles[i];
    for (int k = 0; k < 3; ++k) {
      tri_v[i * 3 + k] = t.v[k];
      tri_t[i * 3 + k] = t.t[k];
      tri_n[i * 3 + k] = t.n[k];
    }
    tri_mat[i] = t.material;
  }
  for (size_t i = 0; i < m->materials.size(); ++i) {
    const Material& mat = m->materials[i];
    for (int k = 0; k < 3; ++k) {
      mat_ka[i * 3 + k] = mat.ka[k];
      mat_kd[i * 3 + k] = mat.kd[k];
      mat_ks[i * 3 + k] = mat.ks[k];
    }
    mat_ns[i] = mat.ns;
    mat_tr[i] = mat.tr;
    mat_ni[i] = mat.ni;
  }
  int64_t off = 0;
  for (size_t g = 0; g < m->groups.size(); ++g) {
    group_start[g] = off;
    for (int32_t t : m->groups[g]) group_tris[off++] = t;
  }
  group_start[m->groups.size()] = off;
  char* p = names;
  for (const auto& name : m->group_names) {
    std::memcpy(p, name.c_str(), name.size() + 1);
    p += name.size() + 1;
  }
  for (const auto& mat : m->materials) {
    std::memcpy(p, mat.name.c_str(), mat.name.size() + 1);
    p += mat.name.size() + 1;
  }
}

void mcpt_obj_free(void* handle) { delete static_cast<Model*>(handle); }

// ---- KD-tree builder ------------------------------------------------------

void* mcpt_kd_build(const float* a, const float* b, const float* c,
                    const uint8_t* valid, int64_t T) {
  return build_kdtree(a, b, c, valid, T).release();
}

void mcpt_kd_counts(void* handle, int64_t* n_nodes, int64_t* n_leaf_tris) {
  auto* k = static_cast<KDTreeBuild*>(handle);
  *n_nodes = static_cast<int64_t>(k->node_skip.size());
  *n_leaf_tris = static_cast<int64_t>(k->leaf_tris.size());
}

void mcpt_kd_fill(void* handle, float* node_lo, float* node_hi,
                  int32_t* node_skip, int32_t* leaf_start,
                  int32_t* leaf_count, int32_t* leaf_tris) {
  auto* k = static_cast<KDTreeBuild*>(handle);
  std::memcpy(node_lo, k->node_lo.data(), k->node_lo.size() * sizeof(float));
  std::memcpy(node_hi, k->node_hi.data(), k->node_hi.size() * sizeof(float));
  std::memcpy(node_skip, k->node_skip.data(),
              k->node_skip.size() * sizeof(int32_t));
  std::memcpy(leaf_start, k->leaf_start.data(),
              k->leaf_start.size() * sizeof(int32_t));
  std::memcpy(leaf_count, k->leaf_count.data(),
              k->leaf_count.size() * sizeof(int32_t));
  std::memcpy(leaf_tris, k->leaf_tris.data(),
              k->leaf_tris.size() * sizeof(int32_t));
}

void mcpt_kd_free(void* handle) { delete static_cast<KDTreeBuild*>(handle); }

int mcpt_abi_version() { return 2; }

}  // extern "C"
