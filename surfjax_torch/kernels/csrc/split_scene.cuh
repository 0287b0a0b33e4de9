// The block the split path's per-ray stages run on for scenes without a
// crowd (SplitScene), shared by K1 and K2 (split_staged.cu), ao_fix
// (ao_fix_staged.cu) and the priming kernel (prime_tile.cu). The stages
// themselves are kf_staged.cuh's, templates on the block type. floor_of
// hands its hoisted floor to the crowd kernels (split_path.cu,
// ao_fix_crowd.cu).
#pragma once

#include "kf_staged.cuh"

// The block the stages run on. T: the tables' pointers, by value; STAGE
// (K2, the priming kernel): into shared memory, where stage_scene put the
// tables and both bounding spheres of every object; else (K1, ao_fix) the
// parameters' global tables, each bound computed where it is used. Tm:
// the same tables as a struct in memory (the parameters, or the staged
// copy in shared memory), for the out-of-line cores.
template <bool STAGE>
struct SplitScene {
  KFTables T;
  const KFTables& Tm;
  const float* bounds;   // STAGE: lower, cover per object
  float margin;          // !STAGE: the cover's exit margin
  // AO's unbounded group when it is one object whose tape is one leaf
  // (one_leaf): that leaf's kind, parameters and p1, decoded by hoist
  int one_leaf, kind, p1;
  const float* prm;

  __device__ __forceinline__ void hoist(const KFSettings& S) {
    one_leaf = 0;
    const int n_rest = S.n_ana + S.n_sdf;
    const int* rest = T.order + n_rest;
    int n_unb = 0, oi = 0;
    for (int k = 0; k < n_rest; ++k) {
      if (!object_row(T, rest[k])[O_BOUNDABLE]) {
        n_unb += 1;
        oi = rest[k];
      }
    }
    if (n_unb == 1 && object_row(T, oi)[O_NNODES] == 1) {
      const int* ob = object_row(T, oi);
      const int* lf = T.leaves +
          (ob[O_LEAF0] + T.nodes[ob[O_NODE0] * KF_NODE_W + 3]) * KF_LEAF_W;
      one_leaf = 1;
      kind = lf[0];
      p1 = lf[4];
      prm = T.leaf_params + lf[1] * KF_LEAF_PARAM_W;
    }
  }

  __device__ __forceinline__ Bound lower(int oi) const {
    if constexpr (STAGE) {
      const float* b = bounds + oi * 8;
      return Bound{b[0], b[1], b[2], b[3]};
    } else {
      return object_bound(Tm, object_row(T, oi), 1, 0.0f);
    }
  }
  __device__ __forceinline__ Bound cover(int oi) const {
    if constexpr (STAGE) {
      const float* b = bounds + oi * 8 + 4;
      return Bound{b[0], b[1], b[2], b[3]};
    } else {
      return object_bound(Tm, object_row(T, oi), 0, margin);
    }
  }
  // eval_obj of a one-node tape: its leaf (vals[0] is that leaf's value)
  __device__ __forceinline__ float eval(const KFSettings& S, const int* ob,
                                        V3 p, int cap) const {
    if (ob[O_NNODES] == 1) {
      const int* lf = T.leaves +
          (ob[O_LEAF0] + T.nodes[ob[O_NODE0] * KF_NODE_W + 3]) * KF_LEAF_W;
      return eval_leaf(S, lf[0], T.leaf_params + lf[1] * KF_LEAF_PARAM_W, p,
                       lf[4], cap);
    }
    return eval_obj(Tm, S, ob, p, cap);
  }
  // intersect_analytic of one leaf under a one-node tape
  __device__ __forceinline__ float intersect(const int* ob, V3 o, V3 d,
                                             float t_lo, float t_hi,
                                             int& leaf) const {
    if (ob[O_NLEAVES] == 1 && ob[O_NNODES] == 1) {
      const int* lf = T.leaves + ob[O_LEAF0] * KF_LEAF_W;
      float i0, i1;
      leaf_interval(lf[0], T.leaf_params + lf[1] * KF_LEAF_PARAM_W, o, d,
                    i0, i1);
      leaf = 0;
      bool e0 = (i0 > t_lo) && (i0 < t_hi);
      bool e1 = (i1 > t_lo) && (i1 < t_hi);
      return e0 ? i0 : (e1 ? i1 : KF_BIG);
    }
    return intersect_analytic(Tm, ob, o, d, t_lo, t_hi, leaf);
  }
  // AO's unbounded group: the one leaf decoded by hoist, or every object
  // without a bound in order (unbounded_loop); the same value either way
  template <bool PROF>
  __device__ __forceinline__ bool unbounded_min(const KFSettings& S, V3 q,
                                                float& hmin,
                                                Prof<PROF>& P) const {
    if (one_leaf) {
      hmin = eval_leaf(S, kind, prm, q, p1, S.ao_lod);
      P.trip(PH_AO_UNB);
      return true;
    }
    return unbounded_loop(*this, S, q, hmin, P);
  }
};

// AO's floor as SplitScene::hoist decodes it, for the crowd kernels' AO
// core (ao_factor_culled): K1 with a crowd and ao_fix with a crowd.
static __device__ __forceinline__ Floor floor_of(const KFTables& T,
                                                 const KFSettings& S) {
  SplitScene<false> B{T, T, nullptr, S.exit_margin};
  B.hoist(S);
  return B.one_leaf ? Floor{true, B.kind, B.p1, B.prm}
                    : Floor{false, 0, 0, nullptr};
}
