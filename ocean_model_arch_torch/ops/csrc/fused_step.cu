// Fused shallow-water step for Hopper (sm_90a): one launch advances the
// 6 carried fields (ssh, sshp, u, up, v, vp) by one whole model step.
//
// Replaces: ocean_model_arch_tpu/ops/pallas/fused_step.py::
//   build_fused_sw_step -> _make_kernel (pallas_call at :1642), fast
//   branch with x-uniform latitude-profile metrics, full free surface,
//   momentum advection, no viscosity (mu = 0) and no tracers.
//   Plain PyTorch version: ops/fused_step.py::fused_sw_step_reference,
//   which evaluates the same formulas in the same order.
//
// What bounds it: memory. Per point and step it must read 10 f32 planes
// (6 fields + rslu_u, rslu_v, rslu_h, ludxdy) and write 6, 64 bytes,
// against roughly 100 flops (two divisions among them): at the H100's
// 3.35 TB/s HBM that is about 19 ns per thousand points, far above the
// compute time.
//
// What the design does about it: every intermediate of the step (the
// weighted depth column aq, the depths hu/hv/hh and hup/hvp, the mass
// fluxes, sshn, the vorticity, the edge fluxes F/G/K/L and the merged
// vorticity+Coriolis products, un/vn) lives in shared memory or
// registers and never touches device memory, so the kernel moves only
// those 64 bytes per point plus the tile halos, which neighbouring
// blocks re-read mostly from L2. A block owns a TX x TY tile of outputs
// and loads a (TX+6) x (TY+6) window (the step's stencil reach is at most
// 3 cells on either side); each stage then runs on a region whose halo
// shrinks by one cell per stencil level (3 -> 2 -> 1 -> 0), with
// __syncthreads() between stages. y, the contiguous axis, runs along
// threadIdx so each warp reads consecutive addresses. Cells outside the
// array read as 0 (land); the layout's 4-cell land margin keeps every
// read of an interior cell inside the array.
//
// The per-block max |ssh| over interior cells feeds the stability guard
// and propagates NaN (fmaxf would drop it). Land-only divisions are
// skipped by branching on the wet mask before dividing.

#include <cuda_runtime.h>

namespace {

// Tile: 16 x 32 outputs, 512 threads, 53.5 KB of shared memory per
// block. Swept at the production layout on an H100 SXM (700 W): 16x32
// with 512 threads 75.0 us/launch; 16x16, 12x32 and 8x32 with 256
// threads 76-78 us; 32x32 108 us; 32x64 172 us. Small tiles keep more
// blocks, and so more loads, in flight per SM; their halo re-reads hit L2.
constexpr int TX = 16;                 // output rows (x) per block
constexpr int TY = 32;                 // output columns (y) per block
constexpr int HALO = 3;                // stencil reach of one step
constexpr int WX = TX + 2 * HALO;      // window rows
constexpr int WY = TY + 2 * HALO;      // window columns
constexpr int PLANE = WX * WY;         // floats per shared-memory array
constexpr int NTHREADS = 512;
constexpr int NWARPS = NTHREADS / 32;

// shared-memory arrays, each a WX x WY window
enum {
  S_SSH, S_U, S_V, S_LD,     // loaded fields; LD = lu*dx*dy (> 0.5: wet)
  S_AQ, S_AQP,               // weighted depth columns of ssh and sshp
  S_HU, S_HV, S_UD, S_VD,    // depth interps (carry dyh / dxh), fluxes
  S_F, S_K, S_RX, S_SY,      // edge fluxes and the merged shifted terms
  S_CX, S_CY,                // centre terms of the advection tails
  N_SMEM
};
constexpr size_t SMEM_BYTES = sizeof(float) * N_SMEM * PLANE;

// profile rows read by the kernel (ops/fused_layout.py row meanings)
constexpr int R_RDXDY = 9, R_RDXT = 10, R_RDYT = 11;
constexpr int R_VORT_V = 16, R_VORT_UY = 17, R_VORT_U = 18, R_CORIO = 21;

struct Params {
  const float* ssh; const float* sshp;
  const float* u; const float* up;
  const float* v; const float* vp;
  const float* met;      // (24, Ys) latitude profiles
  const float* planes;   // (4, Xs, Ys): rslu_u, rslu_v, rslu_h, ludxdy
  float* ssh_o; float* sshp_o;
  float* u_o; float* up_o;
  float* v_o; float* vp_o;
  float* blockmax;       // one max |ssh| per block
  int Xs, Ys, nx, ny, margin;
  float hr;              // flat rest bathymetry
  float neg_g;           // -FREE_FALL_ACC
  float two_tau, neg_two_tau;
  float ts1, ts2;        // 1 - time_smooth, time_smooth / 2
};

__device__ __forceinline__ float nan_max(float m, float v) {
  return (v != v || v > m) ? v : m;
}

__device__ __forceinline__ bool inside(const Params& p, int gx, int gy) {
  return gx >= 0 && gx < p.Xs && gy >= 0 && gy < p.Ys;
}

__global__ void __launch_bounds__(NTHREADS)
fused_sw_step_kernel(const Params p) {
  extern __shared__ float sm[];
  float* s_ssh = sm + S_SSH * PLANE;
  float* s_u = sm + S_U * PLANE;
  float* s_v = sm + S_V * PLANE;
  float* s_ld = sm + S_LD * PLANE;
  float* s_aq = sm + S_AQ * PLANE;
  float* s_aqp = sm + S_AQP * PLANE;
  float* s_hu = sm + S_HU * PLANE;
  float* s_hv = sm + S_HV * PLANE;
  float* s_ud = sm + S_UD * PLANE;
  float* s_vd = sm + S_VD * PLANE;
  float* s_f = sm + S_F * PLANE;
  float* s_k = sm + S_K * PLANE;
  float* s_rx = sm + S_RX * PLANE;
  float* s_sy = sm + S_SY * PLANE;
  float* s_cx = sm + S_CX * PLANE;
  float* s_cy = sm + S_CY * PLANE;
  __shared__ float s_red[NWARPS];

  const int tid = threadIdx.x;
  const int x0 = blockIdx.y * TX - HALO;   // global row of window row 0
  const int y0 = blockIdx.x * TY - HALO;   // global column of window col 0
  const size_t plane = (size_t)p.Xs * p.Ys;
  const float* rslu_u = p.planes;
  const float* rslu_v = p.planes + plane;
  const float* rslu_h = p.planes + 2 * plane;
  const float* ludxdy = p.planes + 3 * plane;
  const int W = 1;                          // one window row/col offset
  const int S = WY;                         // window row stride

  // stage 0 (halo 3): load the window; aq = (ssh + hr) * lu*dx*dy
  for (int i = tid; i < PLANE; i += NTHREADS) {
    const int gx = x0 + i / WY, gy = y0 + i % WY;
    float ssh = 0.f, u = 0.f, v = 0.f, ld = 0.f;
    if (inside(p, gx, gy)) {
      const size_t g = (size_t)gx * p.Ys + gy;
      ssh = p.ssh[g]; u = p.u[g]; v = p.v[g]; ld = ludxdy[g];
    }
    s_ssh[i] = ssh; s_u[i] = u; s_v[i] = v; s_ld[i] = ld;
    s_aq[i] = (ssh + p.hr) * ld;
  }
  __syncthreads();

  // stage 1 (halo 2): depth interps hu = hhu*dyh, hv = hhv*dxh and the
  // mass fluxes; the previous-level column aqp (halo 1)
  {
    const int h = 2, w = TY + 2 * h, n = (TX + 2 * h) * w;
    for (int i = tid; i < n; i += NTHREADS) {
      const int a = HALO - h + i / w, b = HALO - h + i % w;
      const int k = a * S + b, gx = x0 + a, gy = y0 + b;
      float ru = 0.f, rv = 0.f;
      if (inside(p, gx, gy)) {
        const size_t g = (size_t)gx * p.Ys + gy;
        ru = rslu_u[g]; rv = rslu_v[g];
      }
      const float hu = (s_aq[k] + s_aq[k + S]) * ru;
      const float hv = (s_aq[k] + s_aq[k + W]) * rv;
      s_hu[k] = hu; s_hv[k] = hv;
      s_ud[k] = s_u[k] * hu;
      s_vd[k] = s_v[k] * hv;
    }
  }
  {
    const int h = 1, w = TY + 2 * h, n = (TX + 2 * h) * w;
    for (int i = tid; i < n; i += NTHREADS) {
      const int a = HALO - h + i / w, b = HALO - h + i % w;
      const int k = a * S + b, gx = x0 + a, gy = y0 + b;
      const float sshp = inside(p, gx, gy)
          ? p.sshp[(size_t)gx * p.Ys + gy] : 0.f;
      s_aqp[k] = (sshp + p.hr) * s_ld[k];
    }
  }
  __syncthreads();

  // stage 2 (halo 1): vorticity, edge fluxes, vorticity + Coriolis
  {
    const int h = 1, w = TY + 2 * h, n = (TX + 2 * h) * w;
    for (int i = tid; i < n; i += NTHREADS) {
      const int a = HALO - h + i / w, b = HALO - h + i % w;
      const int k = a * S + b, gx = x0 + a, gy = y0 + b;
      float rh = 0.f, m16 = 0.f, m17 = 0.f, m18 = 0.f, m21 = 0.f;
      if (inside(p, gx, gy)) {
        rh = rslu_h[(size_t)gx * p.Ys + gy];
        m16 = p.met[R_VORT_V * p.Ys + gy];
        m17 = p.met[R_VORT_UY * p.Ys + gy];
        m18 = p.met[R_VORT_U * p.Ys + gy];
        m21 = p.met[R_CORIO * p.Ys + gy];
      }
      const float su = s_aq[k] + s_aq[k + S];
      const float hh = (su + (s_aq[k + W] + s_aq[k + S + W])) * rh;
      const bool wluu = s_ld[k] > 0.5f && s_ld[k + S] > 0.5f
          && s_ld[k + W] > 0.5f && s_ld[k + S + W] > 0.5f;
      const float u = s_u[k], v = s_v[k];
      const float ux = s_u[k + S], uy = s_u[k + W];
      const float vx = s_v[k + S], vy = s_v[k + W];
      // vorticity/4 (rows 16-18 carry the 1/4)
      const float vort = wluu ? (vx - v) * m16 - uy * m17 + u * m18 : 0.f;
      const float s2u = uy + u, s2v = vx + v;
      const float ud = s_ud[k], vd = s_vd[k];
      const float F = (ud + s_ud[k + S]) * ((u + ux) * 0.25f);
      const float G = ((vd + s_vd[k + S]) * 0.25f) * (wluu ? s2u : 0.f);
      const float K = (vd + s_vd[k + W]) * ((v + vy) * 0.25f);
      const float L = ((ud + s_ud[k + W]) * 0.25f) * s2v;
      const float vc = (vort + m21) * hh;
      const float Px = vc * s2v, Ty = vc * s2u;
      s_f[k] = F; s_k[k] = K;
      s_rx[k] = Px + G;
      s_sy[k] = L - Ty;
      s_cx[k] = (Px - F) - G;
      s_cy[k] = (-Ty - L) - K;
    }
  }
  __syncthreads();

  // stage 3 (halo 0): continuity, momentum, leapfrog + filter, outputs
  float mx = 0.f;
  for (int i = tid; i < TX * TY; i += NTHREADS) {
    const int a = HALO + i / TY, b = HALO + i % TY;
    const int k = a * S + b, gx = x0 + a, gy = y0 + b;
    if (!inside(p, gx, gy)) continue;
    const size_t g = (size_t)gx * p.Ys + gy;
    const float ssh = s_ssh[k], sshp = p.sshp[g];
    const float u = s_u[k], up = p.up[g];
    const float v = s_v[k], vp = p.vp[g];
    const bool wlu = s_ld[k] > 0.5f;
    const bool wlcu = wlu && s_ld[k + S] > 0.5f;
    const bool wlcv = wlu && s_ld[k + W] > 0.5f;

    // continuity: sshn = sshp - 2 tau div(flux) / (dx dy)
    const float div = ((s_ud[k] - s_ud[k - S]) + s_vd[k]) - s_vd[k - W];
    const float sshn = sshp + div * (p.neg_two_tau * p.met[R_RDXDY * p.Ys + gy]);

    // momentum: (up*bp0 + grx)/bp with the bp metric factor cancelled
    float un = 0.f, vn = 0.f;
    if (wlcu) {
      const float hu = s_hu[k];
      const float hup = (s_aqp[k] + s_aqp[k + S]) * rslu_u[g];
      const float slx = (s_ssh[k + S] - ssh) * hu * p.neg_g;
      const float acx = (s_cx[k] + s_rx[k - W]) + s_f[k - S];
      const float grx = slx + acx;
      un = (up * hup + grx * (p.two_tau * p.met[R_RDXT * p.Ys + gy])) / hu;
    }
    if (wlcv) {
      const float hv = s_hv[k];
      const float hvp = (s_aqp[k] + s_aqp[k + W]) * rslu_v[g];
      const float sly = (s_ssh[k + W] - ssh) * hv * p.neg_g;
      const float acy = (s_cy[k] + s_sy[k - S]) + s_k[k - W];
      const float gry = sly + acy;
      vn = (vp * hvp + gry * (p.two_tau * p.met[R_RDYT * p.Ys + gy])) / hv;
    }

    // leapfrog rotation + Robert-Asselin filter
    const float ssh_new = wlu ? sshn : ssh;
    p.ssh_o[g] = ssh_new;
    p.sshp_o[g] = wlu ? p.ts1 * ssh + p.ts2 * (sshn + sshp) : sshp;
    p.u_o[g] = wlcu ? un : u;
    p.up_o[g] = wlcu ? p.ts1 * u + p.ts2 * (un + up) : up;
    p.v_o[g] = wlcv ? vn : v;
    p.vp_o[g] = wlcv ? p.ts1 * v + p.ts2 * (vn + vp) : vp;

    if (gx >= p.margin && gx < p.margin + p.nx
        && gy >= p.margin && gy < p.margin + p.ny)
      mx = nan_max(mx, fabsf(ssh_new));
  }

  // block max |ssh|, NaN-propagating
  for (int off = 16; off > 0; off >>= 1)
    mx = nan_max(mx, __shfl_down_sync(0xffffffffu, mx, off));
  if ((tid & 31) == 0) s_red[tid >> 5] = mx;
  __syncthreads();
  if (tid < 32) {
    mx = tid < NWARPS ? s_red[tid] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      mx = nan_max(mx, __shfl_down_sync(0xffffffffu, mx, off));
    if (tid == 0) p.blockmax[blockIdx.y * gridDim.x + blockIdx.x] = mx;
  }
}

dim3 grid_of(int Xs, int Ys) {
  return dim3((Ys + TY - 1) / TY, (Xs + TX - 1) / TX);
}

}  // namespace

extern "C" {

int fused_sw_step_blocks(int Xs, int Ys) {
  const dim3 g = grid_of(Xs, Ys);
  return (int)(g.x * g.y);
}

const char* fused_sw_step_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches one step on `stream`; returns cudaGetLastError() (0 = launched).
int fused_sw_step_launch(
    const float* ssh, const float* sshp, const float* u, const float* up,
    const float* v, const float* vp, const float* met, const float* planes,
    float* ssh_o, float* sshp_o, float* u_o, float* up_o, float* v_o,
    float* vp_o, float* blockmax, int Xs, int Ys, int nx, int ny,
    int margin, float hr, float neg_g, float two_tau, float neg_two_tau,
    float ts1, float ts2, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      fused_sw_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const Params p{ssh, sshp, u, up, v, vp, met, planes,
                 ssh_o, sshp_o, u_o, up_o, v_o, vp_o, blockmax,
                 Xs, Ys, nx, ny, margin, hr, neg_g, two_tau, neg_two_tau,
                 ts1, ts2};
  fused_sw_step_kernel<<<grid_of(Xs, Ys), NTHREADS, SMEM_BYTES,
                         (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
