// Smoothed-aggregation algebraic multigrid SETUP for the p=1 coarse solve.
//
// Native (C++) replacement for the capability the reference gets from
// PETSc's GAMG (reference elasticity.c:568-585: PREONLY+GAMG coarse solve
// of the assembled p=1 matrix; also the whole PC at degree 1,
// elasticity.c:519-521). The numerical CYCLE runs on the device inside jit
// (solve/amg.py); this library owns the irregular, pointer-chasing setup:
// strength graph, greedy aggregation, prolongator smoothing, Galerkin
// triple products, and value-only refreshes with a frozen hierarchy so the
// device cycle keeps static shapes across Newton iterations.
//
// Block-aware for 3-component vector problems (3x3 node blocks, aggregation
// on the node graph, translations-only tentative prolongator -- matching
// GAMG's default behavior when no near-nullspace is attached, as in the
// reference).
//
// Plain C API over flat CSR arrays; no external dependencies.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>
#include <unordered_map>

namespace {

struct CSR {
  int n = 0;                    // rows
  int m = 0;                    // cols
  std::vector<int64_t> rowptr;
  std::vector<int> colind;
  std::vector<double> vals;
};

// C = A * B (classic row-merge SpGEMM with a dense accumulator marker)
CSR spgemm(const CSR &A, const CSR &B) {
  CSR C;
  C.n = A.n;
  C.m = B.m;
  C.rowptr.assign(A.n + 1, 0);
  std::vector<int> marker(B.m, -1);
  // symbolic
  for (int i = 0; i < A.n; i++) {
    int64_t count = 0;
    for (int64_t jp = A.rowptr[i]; jp < A.rowptr[i + 1]; jp++) {
      int j = A.colind[jp];
      for (int64_t kp = B.rowptr[j]; kp < B.rowptr[j + 1]; kp++) {
        int k = B.colind[kp];
        if (marker[k] != i) { marker[k] = i; count++; }
      }
    }
    C.rowptr[i + 1] = C.rowptr[i] + count;
  }
  C.colind.resize(C.rowptr[A.n]);
  C.vals.assign(C.rowptr[A.n], 0.0);
  std::fill(marker.begin(), marker.end(), -1);
  std::vector<int64_t> where(B.m, -1);
  // numeric
  for (int i = 0; i < A.n; i++) {
    int64_t start = C.rowptr[i];
    int64_t len = 0;
    for (int64_t jp = A.rowptr[i]; jp < A.rowptr[i + 1]; jp++) {
      int j = A.colind[jp];
      double av = A.vals[jp];
      for (int64_t kp = B.rowptr[j]; kp < B.rowptr[j + 1]; kp++) {
        int k = B.colind[kp];
        if (marker[k] != i) {
          marker[k] = i;
          where[k] = start + len;
          C.colind[start + len] = k;
          C.vals[start + len] = av * B.vals[kp];
          len++;
        } else {
          C.vals[where[k]] += av * B.vals[kp];
        }
      }
    }
    // sort row by column for reproducibility
    std::vector<std::pair<int, double>> row(len);
    for (int64_t t = 0; t < len; t++)
      row[t] = {C.colind[start + t], C.vals[start + t]};
    std::sort(row.begin(), row.end());
    for (int64_t t = 0; t < len; t++) {
      C.colind[start + t] = row[t].first;
      C.vals[start + t] = row[t].second;
    }
  }
  return C;
}

CSR transpose(const CSR &A) {
  CSR T;
  T.n = A.m;
  T.m = A.n;
  T.rowptr.assign(A.m + 1, 0);
  for (int64_t p = 0; p < (int64_t)A.colind.size(); p++)
    T.rowptr[A.colind[p] + 1]++;
  for (int i = 0; i < A.m; i++) T.rowptr[i + 1] += T.rowptr[i];
  T.colind.resize(A.colind.size());
  T.vals.resize(A.vals.size());
  std::vector<int64_t> next(T.rowptr.begin(), T.rowptr.end() - 1);
  for (int i = 0; i < A.n; i++) {
    for (int64_t p = A.rowptr[i]; p < A.rowptr[i + 1]; p++) {
      int64_t q = next[A.colind[p]]++;
      T.colind[q] = i;
      T.vals[q] = A.vals[p];
    }
  }
  return T;
}

// power iteration estimate of lambda_max(D^{-1} A)
double est_lambda_max(const CSR &A, const std::vector<double> &dinv) {
  std::vector<double> x(A.n), y(A.n);
  uint64_t seed = 0x9e3779b97f4a7c15ULL;
  for (int i = 0; i < A.n; i++) {
    seed = seed * 6364136223846793005ULL + 1442695040888963407ULL;
    x[i] = ((double)(seed >> 11) / (double)(1ULL << 53)) - 0.5;
  }
  double lam = 1.0;
  for (int it = 0; it < 12; it++) {
    double nrm = 0.0;
    for (int i = 0; i < A.n; i++) nrm += x[i] * x[i];
    nrm = std::sqrt(nrm);
    if (nrm == 0) break;
    for (int i = 0; i < A.n; i++) x[i] /= nrm;
    for (int i = 0; i < A.n; i++) {
      double acc = 0.0;
      for (int64_t p = A.rowptr[i]; p < A.rowptr[i + 1]; p++)
        acc += A.vals[p] * x[A.colind[p]];
      y[i] = dinv[i] * acc;
    }
    lam = 0.0;
    for (int i = 0; i < A.n; i++) lam += x[i] * y[i];
    x.swap(y);
  }
  return std::max(lam, 1e-12);
}

struct Level {
  CSR A;          // (3*nn) x (3*nn)
  CSR P;          // fine(3*nn_f) x coarse(3*nn_c): from next level to this
  CSR PT;
  std::vector<double> diag, dinv;
  double lam_max = 1.0;
};

struct Hierarchy {
  std::vector<Level> levels;        // levels[0] = finest
  std::vector<double> coarse_dense; // row-major (nc x nc)
  int coarse_n = 0;
  double theta = 0.0;
  double omega = 0.666666666666667; // 2/3 (divided by lam_max at use)
};

void compute_diag(const CSR &A, std::vector<double> &diag,
                  std::vector<double> &dinv) {
  diag.assign(A.n, 0.0);
  for (int i = 0; i < A.n; i++)
    for (int64_t p = A.rowptr[i]; p < A.rowptr[i + 1]; p++)
      if (A.colind[p] == i) diag[i] = A.vals[p];
  dinv.resize(A.n);
  for (int i = 0; i < A.n; i++)
    dinv[i] = (diag[i] != 0.0) ? 1.0 / diag[i] : 1.0;
}

// Node-block strength graph + greedy aggregation.
// A is 3Nx3N; node i block-connected to j if any entry of the 3x3 block is
// nonzero and passes the strength test |a| > theta*sqrt(|aii*ajj|)
// (theta=0 keeps everything, GAMG-like default).
std::vector<int> aggregate(const CSR &A, double theta, int &n_agg) {
  int N = A.n / 3;
  // build node adjacency (unique, excluding self)
  std::vector<std::vector<int>> adj(N);
  std::vector<double> bdiag(N, 0.0);
  for (int i = 0; i < A.n; i++)
    for (int64_t p = A.rowptr[i]; p < A.rowptr[i + 1]; p++)
      if (A.colind[p] == i) bdiag[i / 3] += A.vals[p] * A.vals[p];
  for (int i = 0; i < A.n; i++) {
    int ni = i / 3;
    for (int64_t p = A.rowptr[i]; p < A.rowptr[i + 1]; p++) {
      int nj = A.colind[p] / 3;
      if (nj == ni) continue;
      double a = A.vals[p];
      if (theta > 0.0) {
        double thr = theta * theta * std::sqrt(bdiag[ni] * bdiag[nj]);
        if (a * a <= thr) continue;
      } else if (a == 0.0) {
        continue;
      }
      adj[ni].push_back(nj);
    }
  }
  for (auto &v : adj) {
    std::sort(v.begin(), v.end());
    v.erase(std::unique(v.begin(), v.end()), v.end());
  }
  std::vector<int> agg(N, -1);
  n_agg = 0;
  // Nodes with no off-block connections (Dirichlet-eliminated identity
  // rows, or fully decoupled) are EXCLUDED from coarsening: their residual
  // is handled exactly by the fine-level smoother/masking, and carrying
  // them down pollutes every coarse level with identity blocks.
  for (int i = 0; i < N; i++)
    if (adj[i].empty()) agg[i] = -2;
  // pass 1: root nodes with fully unaggregated neighborhoods
  for (int i = 0; i < N; i++) {
    if (agg[i] != -1) continue;
    bool free_nbhd = true;
    for (int j : adj[i])
      if (agg[j] >= 0) { free_nbhd = false; break; }
    if (!free_nbhd) continue;
    int g = n_agg++;
    agg[i] = g;
    for (int j : adj[i])
      if (agg[j] == -1) agg[j] = g;
  }
  // pass 2: attach stragglers to a neighboring aggregate
  for (int i = 0; i < N; i++) {
    if (agg[i] != -1) continue;
    for (int j : adj[i])
      if (agg[j] >= 0) { agg[i] = agg[j]; break; }
    if (agg[i] == -1) agg[i] = n_agg++;   // isolated free node: own aggregate
  }
  return agg;
}

// Tentative prolongator: translations-only block identity, scaled by
// 1/sqrt(|aggregate|) so columns are orthonormal.
CSR tentative(const std::vector<int> &agg, int n_agg) {
  int N = (int)agg.size();
  std::vector<int> sizes(n_agg, 0);
  for (int i = 0; i < N; i++)
    if (agg[i] >= 0) sizes[agg[i]]++;
  CSR T;
  T.n = 3 * N;
  T.m = 3 * n_agg;
  T.rowptr.assign(T.n + 1, 0);
  for (int i = 0; i < N; i++)
    if (agg[i] >= 0)
      for (int c = 0; c < 3; c++) T.rowptr[3 * i + c + 1] = 1;
  for (int r = 0; r < T.n; r++) T.rowptr[r + 1] += T.rowptr[r];
  T.colind.resize(T.rowptr[T.n]);
  T.vals.resize(T.rowptr[T.n]);
  for (int i = 0; i < N; i++) {
    if (agg[i] < 0) continue;               // excluded node: empty rows
    double s = 1.0 / std::sqrt((double)sizes[agg[i]]);
    for (int c = 0; c < 3; c++) {
      int64_t q = T.rowptr[3 * i + c];
      T.colind[q] = 3 * agg[i] + c;
      T.vals[q] = s;
    }
  }
  return T;
}

// P = (I - omega/lam * D^{-1} A) T
CSR smooth_prolongator(const CSR &A, const std::vector<double> &dinv,
                       double lam, double omega, const CSR &T) {
  CSR DA = A;
  double w = omega / lam;
  for (int i = 0; i < DA.n; i++)
    for (int64_t p = DA.rowptr[i]; p < DA.rowptr[i + 1]; p++)
      DA.vals[p] *= -w * dinv[i];
  // add identity
  for (int i = 0; i < DA.n; i++)
    for (int64_t p = DA.rowptr[i]; p < DA.rowptr[i + 1]; p++)
      if (DA.colind[p] == i) DA.vals[p] += 1.0;
  return spgemm(DA, T);
}

void build_level_aux(Level &L) {
  compute_diag(L.A, L.diag, L.dinv);
  L.lam_max = est_lambda_max(L.A, L.dinv);
}

void dense_from_csr(const CSR &A, std::vector<double> &out) {
  out.assign((size_t)A.n * A.n, 0.0);
  for (int i = 0; i < A.n; i++)
    for (int64_t p = A.rowptr[i]; p < A.rowptr[i + 1]; p++)
      out[(size_t)i * A.n + A.colind[p]] = A.vals[p];
}

}  // namespace

extern "C" {

void *amg_setup(int n, int64_t nnz, const int64_t *rowptr, const int *colind,
                const double *vals, double theta, int max_levels,
                int coarse_size) {
  auto *h = new Hierarchy();
  h->theta = theta;
  Level L0;
  L0.A.n = L0.A.m = n;
  L0.A.rowptr.assign(rowptr, rowptr + n + 1);
  L0.A.colind.assign(colind, colind + nnz);
  L0.A.vals.assign(vals, vals + nnz);
  build_level_aux(L0);
  h->levels.push_back(std::move(L0));

  while ((int)h->levels.size() < max_levels &&
         h->levels.back().A.n > coarse_size) {
    Level &F = h->levels.back();
    int n_agg = 0;
    std::vector<int> agg = aggregate(F.A, h->theta, n_agg);
    if (3 * n_agg >= F.A.n) break;        // no coarsening progress
    CSR T = tentative(agg, n_agg);
    CSR P = smooth_prolongator(F.A, F.dinv, F.lam_max, h->omega, T);
    CSR PT = transpose(P);
    CSR AP = spgemm(F.A, P);
    Level C;
    C.A = spgemm(PT, AP);
    F.P = std::move(P);
    F.PT = std::move(PT);
    build_level_aux(C);
    h->levels.push_back(std::move(C));
  }
  h->coarse_n = h->levels.back().A.n;
  dense_from_csr(h->levels.back().A, h->coarse_dense);
  return h;
}

// Refresh hierarchy VALUES with a new fine matrix of identical sparsity,
// keeping aggregation and prolongator structure frozen (static shapes for
// the jitted device cycle). Prolongator values are also kept frozen.
void amg_refresh(void *hp, const double *vals) {
  auto *h = (Hierarchy *)hp;
  Level &L0 = h->levels[0];
  std::copy(vals, vals + L0.A.vals.size(), L0.A.vals.begin());
  compute_diag(L0.A, L0.diag, L0.dinv);
  L0.lam_max = est_lambda_max(L0.A, L0.dinv);
  for (size_t l = 0; l + 1 < h->levels.size(); l++) {
    Level &F = h->levels[l];
    Level &C = h->levels[l + 1];
    CSR AP = spgemm(F.A, F.P);
    CSR Ac = spgemm(F.PT, AP);
    // same pattern guaranteed (pattern of RAP depends only on patterns)
    C.A.vals = std::move(Ac.vals);
    C.A.colind = std::move(Ac.colind);
    C.A.rowptr = std::move(Ac.rowptr);
    compute_diag(C.A, C.diag, C.dinv);
    C.lam_max = est_lambda_max(C.A, C.dinv);
  }
  dense_from_csr(h->levels.back().A, h->coarse_dense);
}

int amg_num_levels(void *hp) { return (int)((Hierarchy *)hp)->levels.size(); }

void amg_level_dims(void *hp, int level, int64_t *out) {
  auto &L = ((Hierarchy *)hp)->levels[level];
  out[0] = L.A.n;
  out[1] = (int64_t)L.A.colind.size();
  out[2] = L.P.n ? (int64_t)L.P.colind.size() : 0;
  out[3] = L.P.m;                       // coarse dim of P
}

void amg_get_matrix(void *hp, int level, int64_t *rowptr, int *colind,
                    double *vals, double *diag, double *lam_max) {
  auto &L = ((Hierarchy *)hp)->levels[level];
  std::copy(L.A.rowptr.begin(), L.A.rowptr.end(), rowptr);
  std::copy(L.A.colind.begin(), L.A.colind.end(), colind);
  std::copy(L.A.vals.begin(), L.A.vals.end(), vals);
  std::copy(L.diag.begin(), L.diag.end(), diag);
  *lam_max = L.lam_max;
}

void amg_get_prolongator(void *hp, int level, int64_t *rowptr, int *colind,
                         double *vals) {
  auto &L = ((Hierarchy *)hp)->levels[level];
  std::copy(L.P.rowptr.begin(), L.P.rowptr.end(), rowptr);
  std::copy(L.P.colind.begin(), L.P.colind.end(), colind);
  std::copy(L.P.vals.begin(), L.P.vals.end(), vals);
}

void amg_coarse_dense(void *hp, double *out) {
  auto *h = (Hierarchy *)hp;
  std::copy(h->coarse_dense.begin(), h->coarse_dense.end(), out);
}

void amg_free(void *hp) { delete (Hierarchy *)hp; }

}  // extern "C"
