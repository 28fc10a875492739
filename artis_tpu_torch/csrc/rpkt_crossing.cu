// r-packet crossing kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel propagate_blocked
// (artis_tpu/transport/pallas_rpkt.py:1837, body _kernel :314-1822) in its
// resident-table configurations: the 1D spherical grid
// (the default branch, :863-942), the 3D Cartesian grid (`cart3d`,
// :588-631 and :712-750), the 2D cylindrical grid (`cyl2d`, :751-862), the
// detailed bf-rate estimators (`want_bfrate`, :1515-1532), the binned
// expansion opacities (`expansion_mode`, :1136-1200), the deferred events
// of dipole scattering (`inkernel_scatter=False`, :1416-1435, K6: a runtime
// flag, under which electron and thick-cell grey scattering end the lane's
// loop as events for the event pass instead of isotropic redirects; the
// scatter-split uniform is still drawn, so the draw layout does not depend
// on the mode), the multibin radiation-field estimators (`multibin`,
// :1491-1514, K5-multibin) and the detailed J_b_lu line estimators
// (`want_jblue`, :1254-1265, :1346-1363, :1392, K5-jblue). Each packet
// advances through up to max_inner cell crossings (optical-depth draw, shell
// boundary distance, Doppler and abort frequency, continuum opacity with bf
// selection, Sobolev line walk from its cursor or the walk over wavelength
// bins of binned line opacity, in-kernel isotropic electron
// and thick-grey scattering, two half-moves with midpoint J / nuJ /
// ffheating / LUT gamma and bf-heating estimators, Kahan-summed time and the
// boundary overshoot guard). Reference physics: rpkt.cc:604-737.
//
// Design. One thread per packet; the packet state stays in registers for
// the whole crossing loop. Cell values are direct __ldg loads (the 1D walk:
// from shared memory, below). The line walk reads line_nu and the packet's
// tau_factor[mgi, :] row from global memory, starting at the packet's
// cursor. The grid geometry is a template
// parameter (one instantiation per geometry, so the 1D kernel keeps its
// registers); cell bounds at tmin come from the (ncells, ndim) cellmin /
// cellmax tables and the model cell of a propagation cell from the host-built
// mgi_of_cell table, which is how the XLA path maps 1D, 2D and 3D models.
// Expansion-opacity mode is a second template parameter, so the line-walk
// instantiations keep their registers; the NLTE estimator fields (below)
// are a third, so launches without them run the code they ran before those
// fields existed, except the 3D line walk (launch_geom; 11 instantiations).
// Per-cell estimators (ncells x (4 + ngc per LUT estimator + ncont if
// bf-rate + 3 nradbins if multibin + 2 njblue if J_b_lu) floats) accumulate
// in one of two ways, which the wrapper picks by their size: for
// few cells in shared memory per block, flushed to global memory with one
// atomicAdd per nonzero entry at block end; for many cells (2D and 3D
// grids) every lane adds straight into the global rows, since a large
// per-block copy costs its zeroing and flush in every block and cuts the
// blocks per SM (measured crossover between 24 and 26 KB of rows,
// rpkt_kernel.SHARED_ROWS_MAX). The misc counters are reduced in shared
// memory in double.
//
// What bounds it on the card: latency, not bandwidth (every launch runs
// 60-190x above the time its bytes need). Each lane runs a chain of
// dependent crossings and a warp runs as long as its slowest lane, so a
// launch lasts as long as its longest chains, with few warps left to hide
// their latency. What makes a crossing long differs by walk (the kernel's
// own counters, misc[6] and misc[7] over misc[0], on an H100):
// - the 3D line walk (the nebular and classic launches, K2 / K5 / K6):
//   41 lines a crossing on the classic tables, a chain of dependent global
//   loads (line_nu[l], tau_factor[mgi, l]); it sits at 128 registers (4
//   blocks of 128 an SM), and code added to its loop spills or, unbounded,
//   takes 156-161 registers and runs 1.3-1.5x slower;
// - the 1D line walk (K1) and the bin walks (K4): 0.1-0.3 lines or 1.4-2.1
//   bins and 0.3-0.4 bf continua a crossing, so the crossing's own chain
//   takes the time: the cell loads, two Philox draws, the shell distances,
//   the Doppler factors, the estimator atomics;
// - the cylindrical line walk (K3): its row atomics. On kilonova_2d_2dgrid's
//   launches 28.8 advances and 27.8 boundary crossings a lane, 0.015 lines
//   and no bf continuum an advance (with the 101,010-line Fe atom 22.2,
//   21.2, 2.5 and 0). Its 1250 cells' rows (60 KB, 40 KB with the Fe atom)
//   exceed SHARED_ROWS_MAX, so every crossing added 3-4 scalar float
//   atomics to the global rows, and the active lanes of a warp add to as
//   many cells as there are lanes (18.3 distinct cells among 18.9 lanes at
//   a row add), which warp sums cannot merge. Without those atomics the
//   parent took 0.75x on the replayed launches and 0.56x on a forced
//   launch; with a constant boundary distance about 0.97x an advance.
// The 1D walk, the cylindrical line walk and the bin walk of the 1D and
// cylindrical grids, without the NLTE fields, are redesigned for that
// (k1_redesign, k3_redesign, k4_redesign: 4 of the 11 instantiations; the
// other 7 keep their registers and spills; the double forms below):
// (1) the 1D walk copies its tables into shared memory at block start with
//     cp.async, as many groups as fit rpkt_kernel.STAGE_MAX (stage_plan):
//     the default scene's cell, bf and line tables (16.5 KB), the 128-shell
//     scene's cell and bf tables (its 101,010 lines stay in global memory),
//     and reads them with generic loads; it is a kernel of its own bounded
//     to K1_MIN_BLOCKS blocks an SM (118 registers);
// (2) it sums its cell rows across the warp before the atomics
//     (est_add_warp): the lanes of a 1D warp mostly share a shell;
// (3) the bin walk reads its edges from a float32 table in shared memory,
//     the plain version's values (rpkt_kernel.expo_edges), and finds its
//     first bin on that table: no double divide is left in its loop;
// (4) the cylindrical walk adds a cell's four J / nuJ / ffheating /
//     crossing floats with one 16-byte vector reduction (red_add_v4, sm_90)
//     in place of up to four scalar atomics: one memory transaction a
//     crossing (the global rows are 16-byte aligned);
// (5) it keeps the xy terms of its direction (XYDir: a square root and two
//     divides) in registers and recomputes them only after a scatter turns
//     the direction (122 registers, no spill).
// Against the parent kernel on the replayed launches of the main paths
// (chip_smoke.py --kernel-ab, kernel-only time, one call; PERF.md section
// 6): the default scene 0.90x and the 128-shell scene 0.985x (K1), the
// expansion-opacity cylinder 0.94x (K4), the 3D walks 0.99x; the
// cylinder kilonova_2d_2dgrid 0.77x and its Fe-atom form 0.97x (K3, (4)
// alone 0.80x and 0.99x). Measured on K3 and dropped: a persistent grid whose blocks
// keep the rows in shared memory and flush them once (0.95x on the
// synthetic replay but 1.10x on the Fe one and 1.05-1.07x forced: each
// block's flush costs about as many atomics as the crossings it saves, and
// 128 registers spill under its 2-block bound), a 5-block register bound
// (96 registers, 122 bytes of spills, 1.05x on the Fe replay), and warp
// sums (the lanes do not share cells). Measured and dropped on K1 and K4:
// the bf window computed once a crossing, its terms kept per
// thread in shared memory (forced launches 5-8 % faster, the replays
// unchanged: 0.3-0.4 continua a crossing), the kappa row read four bins a
// load (2-4 % slower), and the staging without the register bound (160
// registers, 3 blocks: 1.29x on the forced K1 launch, 1.07x on the
// 128-shell replay). Measured on the 3D walk and dropped: lanes
// sorted by (model cell, cursor), 8 or 16 lines read ahead as independent
// loads, warp sums of a cell's rows, int64 fixed-point rows (order-
// independent sums, 1.08x in K6 and 1.49x on the nebular main path), and
// J_b_lu sums as column ranges of difference rows (1.16x over the nebular
// main path's launches, most of them small).
// The double 3D and cylindrical line walks (the default transport dtype's)
// are redesigned again for double arithmetic, which runs at half the
// float32 rate and pays an IEEE divide as a reciprocal seed, a Newton
// sequence and a slow-path test: (a) the line loop without a divide by a
// divisor fixed for the crossing (line_walk_w64, chosen by w64_redesign in
// their instantiations of the generic kernel), (b) 32-bit counters in every
// double form, which leave both walks 168 registers (3 blocks an SM) and the
// 3D walk no spill (K3 6 bytes; 22 and 18 before), and (c) the double
// library built with contraction; K3 keeps its XYDir in double too. Against
// the parent on the float64 replays of their main paths (chip_smoke.py
// --kernel-ab, kernel-only, one call, an NVIDIA H100 80GB HBM3 at 700 W;
// PERF.md section 6): big_scene_f64 0.82x, nebular_1d_3dgrid_nont_f64
// 0.83x, classic_3d_f64 0.86x, kilonova_2d_2dgrid_f64 0.94x. Measured and
// dropped: a kernel of their own with a register bound (3 blocks: 4 bytes
// of spills in the 3D walk and within 1 % of no bound, ahead on one call
// and behind on another; 2 blocks, no spill at 187 registers: 7-10 % slower
// on the big, nebular and cylinder replays). The double 1D line walk (K1,
// and with it the ff-only form) and the double bin walk of the 1D and
// cylindrical grids (K4), the last double forms on the generic body, take
// their float32 redesigns in double: K1 its tables staged in shared memory
// in 8-byte slots (stage_copy's 8-byte cp.async, rpkt_kernel.STAGE_MAX_F64:
// the default scene's 33,120 bytes), its rows summed across the warp
// (est_add_warp in double) and line_walk_w64; K4 the staged table of its
// double edges, its first bin found on it, 1/dnudl once a crossing
// (bin_walk_w64). Against the parent on their replayed main paths
// (kernel-only, one call, an NVIDIA H100 80GB HBM3 at 700 W; PERF.md section
// 6): default_scene_f64 0.885x, default_opacity3_f64 0.892x, the float64
// expansion-opacity cylinder 0.952x. The double K1 runs in the generic
// kernel (192 registers, 2 blocks an SM): its main paths launch at most 189
// blocks, and a kernel of its own bounded to 3 blocks (156 registers) was
// 0.3-1.0 % slower on default_scene_f64's replay in three calls (on
// default_opacity3_f64's 0.6-1.0 % slower in two, 1.1 % faster in one),
// though 6 % faster on a forced launch of 512 blocks; at 4 blocks (128
// registers, 270 bytes of spills) 5 % slower on both replays. Measured and
// dropped: a staged table of reciprocal edges for the non-relativistic bin
// walk (0.5-2.4 % faster on forced non-relativistic launches, 0.4 % slower
// on the relativistic main path's replay). The caller compacts the moving
// lanes into one launch, in packet order. The estimator sums are float
// atomics, so they depend on the order of the adds, and same-seed runs
// differ in their last bits.
//
// Expansion-opacity mode (port of expansionopacity.get_event_expansion_batch,
// rpkt.cc:199-290). Where the Pallas branch computes all 970 bins of every
// lane at every crossing (a one-hot MXU gather of the kappa rows and a
// triangular-matmul cumsum), each thread here walks only the bins its path
// crosses: from the bin of its comoving frequency toward the red (the
// edges from the table in the launch's precision, above, in the 1D and
// cylindrical walks; computed in double and rounded in the 3D one), reading
// kappa[mgi, b] from the global (ncells, 970) table, adding
// (chi_cont + kappa rho doppler) * (path length in the bin) until the
// optical-depth target is reached. A bin is 35.5 A, about 0.7 % in
// wavelength, so a crossing walks a few bins; the row is a dependent
// chain of loads like the line walk's, from a table of 3.8 MB at 988 cells
// (L2-resident). The JAX semantics are kept where they look odd: bin 0 has
// no upper edge (a packet bluer than LAMBDA_MIN accrues bin 0 from where it
// stands); a packet redder than the last bin has no path length in any bin
// and so sees no event, not even a continuum one.
//
// K5-multibin and K5-jblue are runtime fields of the NLTE instantiations,
// which the launch picks when either is on or a LUT estimator is off. Multibin:
// at the segment midpoint, where J / nuJ are added, the bin of nu_cmf is
// computed in float32 with the Pallas expression (the launch passes the
// float32 edges and width) and J, nuJ and 1 go to the (mgi, bin) row;
// thick cells count too. J_b_lu: inside each thread's line walk, every line
// passed before the terminal line, and the activating line of a
// bound-bound event, reads its column from the int32 jblue_of_line table
// (the Pallas float32 one-hot map jb_map was an MXU workaround) and, for a
// column below njblue, adds (tstart + D / c) * (c e_cmf / nu_cmf) and 1 to
// the (mgi, column) row. Those are one pair of float atomics per swept
// selected line, many lanes of a cell sweeping the same lines: at the chip
// scene's sizes (128 cells, ~12k selected lines, 256 bins) the rows are
// about 12.9 MB and go to global memory. With the LUT estimators off (the
// LUT-off nebular presets) the gamma and bf-heating rows are neither
// computed nor allocated (want_gamma / want_bfheat, pallas_rpkt.py:270-273).
//
// The grey opacity cases 0-3 (the JAX package's opacity_case < 4, which it
// runs on the XLA path, artis_tpu/transport/opacity.py:242-258: a
// free-free continuum) are the runtime field sigma_es of every
// instantiation, with the continuum tables the wrapper hands in
// (rpkt_kernel.ff_only_tables):
// sigma_es 0 takes electron scattering out. Without the detailed bf-rate
// rows the wrapper passes no continuum (ncont 0, the bf loops skipped);
// with them a zero bf_a table takes the bound-free opacity out (and so the
// continuum selection), and ground-continuum indices of -1 the LUT gamma
// and bf-heating rows, while the bf-rate rows accumulate as in every case
// (the JAX package's accumulate_bf_estimators does not look at the opacity
// case). The field is
// a float in place of the constant, read once before the crossing loop, and
// no branch: a flag with branches around the bf loops left the 3D line walk
// 1-3 % slower on its replayed main paths, and the float read inside the
// loop K1 0.5-0.8 % slower on the 128-shell replay (PERF.md, section 6).
//
// Precision. The body is a template over its real type R. The float32
// instantiations are those above (the Pallas kernel's precision). Built with
// -DRPKT_F64 the same source gives their double forms
// (rpkt_crossing_launch_f64), the crossing of transport_dtype="float64",
// the default, which the JAX package runs on its XLA path
// (_rpkt_propagate_once): the body in double, without K3's vector
// reduction (PTX has no vector reduction of doubles), with K1's staged
// tables and warp sums, K3's XYDir and K4's edge table, the 1D, 3D and
// cylindrical line walks redesigned for the card (w64_redesign): the line
// loop without a divide by a divisor fixed for the crossing
// (line_walk_w64), the bin walk likewise (bin_walk_w64), 32-bit counters,
// and the double library built with multiply-add contraction
// (rpkt_kernel.build; the float32 one without).
// Code that only the double forms run sits behind RPKT_F64, so the float32
// unit compiles the float32 instantiations from unchanged source. The
// double forms carry the
// XLA path's float64 differences: no boundary overshoot and no 2e-6 r
// ping-pong guard, no Kahan compensation (t advances by the two half-moves,
// as geometry.move_pkt), h/k and the multibin edges in double, the bin edges
// in double (computed in double in the 3D bin walk), and 53-bit uniforms
// (uniform2d: two a draw, three draws a crossing). The two precisions build into two libraries in
// parallel; each has eleven instantiations.
//
// Random numbers: counter-based Philox4x32-10 keyed by (seed, lane id), with
// (crossing index, sub-stream) as counter, so results depend neither on the
// block size nor on lane order; the PyTorch plain version
// (transport/rpkt_kernel.py:propagate_reference) draws the same numbers.
// Test mode uses injected test_tau / test_sel and fixed redirect uniforms
// z1=0.37, z2=0.81, exactly as the JAX kernel.
//
// Float32 fixes kept from the JAX kernel because they are physics, not TPU
// workarounds: packet energies in units of e0; the exact 2^-50 rescale of
// nu^3 in the free-free opacity; Kahan compensation of the time sum; the
// 3e-6 r boundary overshoot; exclusive optical-depth sums accumulated
// directly (never inclusive minus last, the "immortal packet" note at
// pallas_rpkt.py:75-89).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// scalar launch parameters of a launch in precision R (float or double);
// field order matches _Params / _Params64 in rpkt_kernel.py
template <typename R>
struct RpktParamsT {
  int n, ncells, nprop, nlines, ncont, ngc, nphixs, max_inner, relativistic, test_mode;
  int geom, nx, ny, nz, want_bfrate, shared_rows, expansion, nbins, defer_scatter;
  int nradbins, njblue, want_gamma, want_bfheat;
  int nrow;  // estimator entries per cell, as rpkt_kernel.row_floats counts them
  int stage;  // table groups the 1D line walk stages in shared memory (STAGE_*)
  uint32_t seed_lo, seed_hi;
  R t2, tmin, max_path_step, phixs_dnu, last_nuovernuedge;
  R rb_lo, rb_last, rb_super, rb_delta;  // multibin edges and width
  R sigma_es;  // the Thomson cross-section, or 0: the grey opacity cases 0-3
};

namespace {

// the precision's constants: the speed of light (also the propagation
// speed), its square, h/k (float32: the Pallas kernel's; float64: the XLA
// path's) and the "no event" distance, above any distance and finite in both
template <typename R>
struct K;
template <>
struct K<float> {
  static constexpr float CLIGHT = 2.99792458e10f, CLIGHTSQUARED = 8.9875518e20f;
  static constexpr float HOVERKB = 4.799243681e-11f, BIG = 3.0e38f;
};
template <>
struct K<double> {
  static constexpr double CLIGHT = 2.99792458e10, CLIGHTSQUARED = 8.9875518e20;
  static constexpr double HOVERKB = 4.799243681748932e-11, BIG = 3.0e38;
};
template <typename R>
constexpr bool is_f32 = std::is_same<R, float>::value;

// math functions of either precision (a float argument takes the float
// function, never a double one)
__device__ __forceinline__ float r_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double r_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float r_exp(float x) { return expf(x); }
__device__ __forceinline__ double r_exp(double x) { return exp(x); }
__device__ __forceinline__ float r_log(float x) { return logf(x); }
__device__ __forceinline__ double r_log(double x) { return log(x); }
__device__ __forceinline__ float r_floor(float x) { return floorf(x); }
__device__ __forceinline__ double r_floor(double x) { return floor(x); }
__device__ __forceinline__ float r_cos(float x) { return cosf(x); }
__device__ __forceinline__ double r_cos(double x) { return cos(x); }
__device__ __forceinline__ float r_sin(float x) { return sinf(x); }
__device__ __forceinline__ double r_sin(double x) { return sin(x); }
__device__ __forceinline__ float r_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double r_max(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float r_min(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double r_min(double a, double b) { return fmin(a, b); }

constexpr int BOUNDARY_ESCAPE = -99;
constexpr int NMISC = 8;
constexpr int BLOCK = 128;
// grid geometries (the GridType values)
constexpr int GEOM_SPH = 1, GEOM_CYL = 2, GEOM_CART = 3;
// expansion-opacity bin layout (expansionopacity.py: LAMBDA_MIN, DELTA_LAMBDA)
// and 1e8 c [A/s]; the bin edges are computed in double and rounded to
// float, as the plain version computes them
constexpr double LAMBDA_MIN_A = 534.5, DELTA_LAMBDA_A = 35.5, CLIGHT_ANGSTROM = 2.99792458e18;
// table groups of the 1D line walk's shared-memory staging, in the order the
// wrapper fills its budget (rpkt_kernel.stage_plan): the cell tables, the
// per-continuum bf tables, the per-(cell, continuum) bf tables, the lines
constexpr int STAGE_CELL = 1, STAGE_BF = 2, STAGE_BFCELL = 4, STAGE_LINES = 8;
// blocks per SM the redesigned 1D walk's registers must allow (its own
// __launch_bounds__; staged tables took it to 160 registers and 3 blocks in
// a build without the bound)
constexpr int K1_MIN_BLOCKS = 4;

template <typename R>
struct Lanes {
  const R *px, *py, *pz, *dx, *dy, *dz, *nurf, *nucmf, *erf, *ecmf, *t;
  const int *where, *next_trans, *moving, *lane_id;
  const R *test_tau, *test_sel;
};

template <typename R>
struct Tables {
  const R *cellmin, *cellmax, *nne, *te, *kappagrey, *rho, *chiffpart, *line_nu,
      *tau_factor, *cont_nu_edge, *bf_a, *bf_dep, *cont_phixs, *cont_prob, *gc_nu_edge,
      *expo_kappa;
  const int *mgi_of_cell, *thick, *cont_gidx, *jblue_of_line;
  const R* expo_nu_lo;  // the bins' lower edges (rpkt_kernel.expo_edges)
};

template <typename R>
struct Outs {
  R *px, *py, *pz, *dx, *dy, *dz, *nurf, *nucmf, *erf, *ecmf, *t, *chi_escat, *chi_ff,
      *chi_bf, *chi_cont, *em_x, *em_y, *em_z, *em_t;
  int *where, *next_trans, *evented, *escaped, *thick, *is_bb, *act_line, *bf_idx, *mgi, *nsc,
      *inkscat;
  R *est, *gamma, *bfheat, *bfrate, *radbin, *jblue;
  double *misc;
};

// a table load: through the read-only path, or (GEN, the 1D line walk whose
// tables may lie in shared memory) a generic load
template <bool GEN, typename T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (GEN) return *p;
  else return __ldg(p);
}

// asynchronous copies of a table into shared memory (cp.async), one
// element each: 4 bytes (floats, ints) or 8 (doubles); the block waits for
// all of them with cp_async_wait_all and a barrier
template <typename T>
__device__ __forceinline__ void stage_copy(T* dst, const T* src, int n) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "4- or 8-byte elements");
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
#ifdef __CUDA_ARCH__
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst + i);
    if constexpr (sizeof(T) == 8)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src + i) : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src + i) : "memory");
#else
    dst[i] = src[i];
#endif
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// adds (v0, v1, v2, v3) to the 4-entry row of this lane's cell (float or
// double): the lanes of a warp on the same cell (key) sum their values by
// pointer jumping over shuffles, and the lowest of them adds the sums with
// one atomic each
template <typename R>
__device__ __forceinline__ void est_add_warp(R* row, int key, R v0, R v1, R v2, R v3) {
  const unsigned m = __activemask();
  const unsigned peers = __match_any_sync(m, key);
  const int ln = threadIdx.x & 31;
  const unsigned above = peers & (0xFFFFFFFEu << ln);
  int nxt = above ? __ffs(above) - 1 : -1;
  // after step s a lane holds its own value plus those of the next 2^s - 1
  // peers above it; the lowest peer ends with the group's sum
  while (__any_sync(m, nxt >= 0)) {
    const int src = nxt >= 0 ? nxt : ln;
    const R o0 = __shfl_sync(m, v0, src), o1 = __shfl_sync(m, v1, src);
    const R o2 = __shfl_sync(m, v2, src), o3 = __shfl_sync(m, v3, src);
    const int on = __shfl_sync(m, nxt, src);
    if (nxt >= 0) {
      v0 += o0;
      v1 += o1;
      v2 += o2;
      v3 += o3;
      nxt = on;
    }
  }
  if ((peers & ((1u << ln) - 1u)) == 0u) {
    atomicAdd(row + 0, v0);
    atomicAdd(row + 1, v1);
    if (v2 != R(0.0)) atomicAdd(row + 2, v2);
    if (v3 != R(0.0)) atomicAdd(row + 3, v3);
  }
}

// adds (v0, v1, v2, v3) to four consecutive floats of global memory, 16-byte
// aligned, with one vector reduction (red.global.add.v4.f32, sm_90): one
// memory transaction where four scalar atomics took four
__device__ __forceinline__ void red_add_v4(float* p, float v0, float v1, float v2, float v3) {
#ifdef __CUDA_ARCH__
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p), "f"(v0), "f"(v1), "f"(v2),
               "f"(v3)
               : "memory");
#else
  atomicAdd(p + 0, v0);
  atomicAdd(p + 1, v1);
  atomicAdd(p + 2, v2);
  atomicAdd(p + 3, v3);
#endif
}

// K3's double form: PTX has vector reductions of .f32 and of packed 16-bit
// types only (ptxas refuses red.global.add.v2.f64 for sm_90a: "Vector
// operand is not allowed for instruction 'red'"), so four scalar atomics,
// the zero ones skipped as the generic body skips them
__device__ __forceinline__ void red_add_v4(double* p, double v0, double v1, double v2,
                                           double v3) {
  atomicAdd(p + 0, v0);
  atomicAdd(p + 1, v1);
  if (v2 != 0.0) atomicAdd(p + 2, v2);
  if (v3 != 0.0) atomicAdd(p + 3, v3);
}

__device__ __forceinline__ void philox4x32(uint32_t c[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
}

// four uniforms in (0, 1): 24 high bits scaled by 2^-24, floored at 1e-12
__device__ __forceinline__ void uniform4(uint32_t lane, uint32_t draw, uint32_t sub,
                                         uint32_t k0, uint32_t k1, float u[4]) {
  uint32_t c[4] = {lane, draw, sub, 0u};
  philox4x32(c, k0, k1);
#pragma unroll
  for (int i = 0; i < 4; ++i) u[i] = fmaxf((float)(c[i] >> 8) * (1.0f / 16777216.0f), 1e-12f);
}

// two float64 uniforms in (0, 1): 53 bits from each pair of words (the high
// 27 of the first, the high 26 of the second) scaled by 2^-53, floored at
// 1e-300 (rng.philox_uniform2d)
__device__ __forceinline__ void uniform2d(uint32_t lane, uint32_t draw, uint32_t sub,
                                          uint32_t k0, uint32_t k1, double u[2]) {
  uint32_t c[4] = {lane, draw, sub, 0u};
  philox4x32(c, k0, k1);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint64_t bits = ((uint64_t)(c[2 * i] >> 5) << 26) | (uint64_t)(c[2 * i + 1] >> 6);
    u[i] = fmax((double)bits * 1.1102230246251565e-16, 1e-300);  // 2^-53
  }
}

template <typename R>
__device__ __forceinline__ R doppler_at(R dx, R dy, R dz, R px, R py,
                                            R pz, R t, bool rel) {
  const R ndotv = (dx * px + dy * py + dz * pz) / t;
  R dop = R(1.0) - ndotv / K<R>::CLIGHT;
  if (rel) {
    const R betasq = (px * px + py * py + pz * pz) / (t * t) / K<R>::CLIGHTSQUARED;
    dop = dop / r_sqrt(r_max(R(1.0) - betasq, R(1e-30)));
  }
  return dop;
}

// distance to an expanding shell (grid.cc:1222-1312), -1 if none: the
// float32 form with an exact 2^-33 rescale in the radial-velocity test and a
// ping-pong guard against re-intersecting the shell just crossed (float32
// only, as the XLA path's, grid.py:298-302). speed is
// the speed along the unit direction d: c for a sphere, the xy-plane speed
// for the circles of the cylindrical grid (with the z parts zero)
template <typename R>
__device__ R shell_distance(R px, R py, R pz, R dx, R dy, R dz,
                                R pos2, R pdotd, R tstart, R radius_t,
                                bool inner, R speed) {
  const R kgeo = R(1.16415321826934814453125e-10);  // 2^-33
  const R st_k = (speed * kgeo) * tstart;
  const R a = R(1.0) - (radius_t / tstart / speed) * (radius_t / tstart / speed);
  const R b = R(2.0) * (pdotd - radius_t * radius_t / tstart / speed);
  const R c = pos2 - radius_t * radius_t;
  const R disc = b * b - R(4.0) * a * c;
  const R sq = r_sqrt(r_max(disc, R(0.0)));
  const R inv2a = R(0.5) / a;
  R d[2] = {(-b + sq) * inv2a, (-b - sq) * inv2a};
  const R rk = radius_t * kgeo;
  const R eps = is_f32<R> ? R(2e-6) * radius_t : R(0.0);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const R fx = px + d[i] * dx, fy = py + d[i] * dy, fz = pz + d[i] * dz;
    const R r2k = r_max(fx * fx + fy * fy + fz * fz, R(1.0)) * (kgeo * kgeo);
    const R dotf = (dx * fx + dy * fy + dz * fz) * kgeo;
    const R a2 = (dotf * dotf) * (st_k * st_k);
    const R b2 = (rk * rk) * r2k;
    const bool bad = inner ? ((dotf > R(0.0)) && (a2 > b2)) : ((dotf <= R(0.0)) || (a2 < b2));
    if (bad || d[i] < eps) d[i] = -R(1.0);
  }
  if (!(disc > R(0.0))) return -R(1.0);
  if (d[0] < R(0.0) && d[1] < R(0.0)) return -R(1.0);
  return (d[0] >= R(0.0) && (d[1] < R(0.0) || d[0] <= d[1])) ? d[0] : d[1];
}

// bf cross-section by linear phixs interpolation with the Kramers tail
// (atomic.h:147-193)
template <bool GEN = false, typename R>
__device__ __forceinline__ R bf_sigma(const R* __restrict__ phixs, int nphixs,
                                          R nu, R edge, R dnu, R last) {
  const R ireal = (nu / edge - R(1.0)) / dnu;
  if (ireal < R(0.0)) return R(0.0);
  if (ireal < (R)(nphixs - 1)) {
    const int i0 = min(max((int)r_floor(ireal), 0), nphixs - 2);
    const R frac = ireal - (R)i0;
    return (R(1.0) - frac) * ld<GEN>(phixs + i0) + frac * ld<GEN>(phixs + i0 + 1);
  }
  const R r = edge * last / r_max(nu, R(1e-30));
  return ld<GEN>(phixs + nphixs - 1) * (r * r * r);
}

// window [lo, hi) of continua with edge <= nu <= edge * last (edges ascend)
template <bool GEN = false, typename R>
__device__ __forceinline__ void bf_window(const R* __restrict__ edges, int ncont, R nu,
                                          R last, int& lo, int& hi) {
  int a = 0, b = ncont;
  while (a < b) {  // first c with edge*last >= nu
    const int m = (a + b) >> 1;
    if (ld<GEN>(edges + m) * last >= nu) b = m; else a = m + 1;
  }
  lo = a;
  a = lo;
  b = ncont;
  while (a < b) {  // first c with edge > nu
    const int m = (a + b) >> 1;
    if (ld<GEN>(edges + m) > nu) b = m; else a = m + 1;
  }
  hi = a;
}

// distance to a homologously expanding plane at coordbound (at tmin): the
// float32 form with a guarded zero denominator (a packet moving with the
// plane never reaches it)
template <typename R>
__device__ __forceinline__ R plane_distance(R posd, R veld, R tstart,
                                                R coordbound, R tmin) {
  R denom = coordbound - veld * tmin;
  if (denom == R(0.0)) denom = R(1e-30);
  return K<R>::CLIGHT * ((posd - veld * tstart) / denom * tmin - tstart);
}

// the xy terms of a direction that the cylindrical boundary distance uses:
// the xy length floored at 1e-8, the unit xy direction, and whether the
// direction moves in xy at all
template <typename R>
struct XYDir {
  R sdl, dxn, dyn;
  bool has_xy;
};

template <typename R>
__device__ __forceinline__ XYDir<R> xy_dir(R dx, R dy) {
  const R dirxylen = r_sqrt(dx * dx + dy * dy);
  const R sdl = r_max(dirxylen, R(1e-8));
  return {sdl, dx / sdl, dy / sdl, dirxylen > R(1e-8)};
}

// distance to the cell boundary and the next cell (-99: leaves the grid),
// capped at max_path_step (grid.cc:2349-2597); with XYC the cylindrical
// distance takes the direction's xy terms from xyc, which the caller keeps
template <int GEOM, bool GEN = false, bool XYC = false, typename R>
__device__ __forceinline__ void boundary(const RpktParamsT<R>& p, const Tables<R>& tb, int cell,
                                         R px, R py, R pz, R dx, R dy,
                                         R dz, R pos2, R pdotd, R tstart,
                                         R& sdist, int& snext, XYDir<R> xyc = XYDir<R>{}) {
  if (GEOM == GEOM_SPH) {
    const R coordmin0 = ld<GEN>(tb.cellmin + cell), coordmax0 = ld<GEN>(tb.cellmax + cell);
    const R d_max = shell_distance(px, py, pz, dx, dy, dz, pos2, pdotd, tstart,
                                       coordmax0 * tstart / p.tmin, false, K<R>::CLIGHT);
    sdist = (d_max >= R(0.0) && d_max < K<R>::BIG) ? d_max : K<R>::BIG;
    snext = d_max >= R(0.0) ? (cell == p.nprop - 1 ? BOUNDARY_ESCAPE : cell + 1) : -1;
    const R r_inner = coordmin0 * tstart / p.tmin;
    const R d_min = r_inner > R(0.0)
        ? shell_distance(px, py, pz, dx, dy, dz, pos2, pdotd, tstart, r_inner, true, K<R>::CLIGHT)
        : -R(1.0);
    if (d_min >= R(0.0) && d_min < sdist) {
      sdist = d_min;
      snext = cell == 0 ? BOUNDARY_ESCAPE : cell - 1;
    }
  } else if (GEOM == GEOM_CYL) {
    // expanding circles in the xy plane for the rcyl bounds (the planar
    // distance over the direction's xy length), homologous planes in z
    const int n0 = p.nx, n1 = p.ny;
    const int i_r = cell % n0, i_z = cell / n0;
    const XYDir<R> xd = XYC ? xyc : xy_dir(dx, dy);
    const bool has_xy = xd.has_xy;
    const R sdl = xd.sdl, dxn = xd.dxn, dyn = xd.dyn;
    const R xyspeed = sdl * K<R>::CLIGHT;
    const R pos2xy = px * px + py * py;
    const R pdotdxy = px * dxn + py * dyn;
    sdist = K<R>::BIG;
    snext = -1;
    const R d_rc = shell_distance(px, py, R(0.0), dxn, dyn, R(0.0), pos2xy, pdotdxy, tstart,
                                      __ldg(tb.cellmax + 2 * cell) * tstart / p.tmin, false,
                                      xyspeed);
    const R d_out = d_rc / sdl;
    if (has_xy && d_rc >= R(0.0) && d_out > R(0.0) && d_out < sdist) {
      sdist = d_out;
      snext = i_r == n0 - 1 ? BOUNDARY_ESCAPE : cell + 1;
    }
    const R r_in = __ldg(tb.cellmin + 2 * cell) * tstart / p.tmin;
    const R d_rc_in = r_in > R(0.0)
        ? shell_distance(px, py, R(0.0), dxn, dyn, R(0.0), pos2xy, pdotdxy, tstart, r_in, true,
                         xyspeed)
        : -R(1.0);
    const R d_in = d_rc_in / sdl;
    if (has_xy && d_rc_in >= R(0.0) && d_in < sdist) {
      sdist = d_in;
      snext = i_r == 0 ? BOUNDARY_ESCAPE : cell - 1;
    }
    const R velz = dz * K<R>::CLIGHT;
    const bool up = (velz * tstart) > pz;
    const R db = plane_distance(
        pz, velz, tstart, __ldg((up ? tb.cellmax : tb.cellmin) + 2 * cell + 1), p.tmin);
    if (db >= R(0.0) && db < sdist) {
      sdist = db;
      const bool at_edge = up ? (i_z == n1 - 1) : (i_z == 0);
      snext = at_edge ? BOUNDARY_ESCAPE : cell + (up ? n0 : -n0);
    }
  } else {
    const int nx = p.nx, ny = p.ny, nz = p.nz;
    const int ci[3] = {cell % nx, (cell / nx) % ny, cell / (nx * ny)};
    const int inc[3] = {1, nx, nx * ny};
    const int nax[3] = {nx, ny, nz};
    const R pv[3] = {px, py, pz};
    const R dv[3] = {dx, dy, dz};
    sdist = K<R>::BIG;
    snext = -1;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const R veld = dv[ax] * K<R>::CLIGHT;
      const bool up = (veld * tstart) > pv[ax];
      const R db = plane_distance(
          pv[ax], veld, tstart, __ldg((up ? tb.cellmax : tb.cellmin) + 3 * cell + ax), p.tmin);
      if (db >= R(0.0) && db < sdist) {
        sdist = db;
        const bool at_edge = up ? (ci[ax] == nax[ax] - 1) : (ci[ax] == 0);
        snext = at_edge ? BOUNDARY_ESCAPE : cell + (up ? inc[ax] : -inc[ax]);
      }
    }
  }
  if (sdist > p.max_path_step) {  // intra-cell step cap (grid.cc:2592-2594)
    sdist = p.max_path_step;
    snext = cell;
  }
}

// the redesigned instantiations: the 1D line walk (K1), the cylindrical
// line walk (K3) and the bin walk of the 1D and cylindrical grids (K4), each
// without the NLTE fields, in both precisions (K1's tables staged in 4- or
// 8-byte elements, K4's edge table in the launch's precision, K3's XYDir; in
// double K3 adds four scalar atomics, red_add_v4). The double line walks of
// the 1D, 3D and cylindrical grids are w64_redesign
template <typename R, int GEOM, bool EXPO, bool NLTE>
__host__ __device__ constexpr bool k1_redesign() {
  return GEOM == GEOM_SPH && !EXPO && !NLTE;
}
template <typename R, int GEOM, bool EXPO, bool NLTE>
__host__ __device__ constexpr bool k3_redesign() {
  return GEOM == GEOM_CYL && !EXPO && !NLTE;
}
// the redesigned double line walks: the 3D walk, always with the NLTE fields
// (K2, K5-bfrate, K5-multibin, K5-jblue and K6), the cylindrical walk (K3)
// and the 1D walk (K1); their line loop is line_walk_w64
template <typename R, int GEOM, bool EXPO, bool NLTE>
__host__ __device__ constexpr bool w64_redesign() {
  return !is_f32<R> && !EXPO && (GEOM == GEOM_CART ? NLTE : !NLTE);
}

// The Sobolev line walk of the redesigned double forms, from the packet's
// cursor (cursor0 < nlines): the generic loop in crossing() without a divide
// whose divisor is fixed for the crossing. 1/dnudl and 1/c are taken once;
// the continuum test compares optical depths, rem <= safe_chi * D, where the
// generic loop compares the distance rem / safe_chi with D, and shares the
// product with the line test; the continuum distance is divided out only
// where it ends the walk. Left in the loop: the non-relativistic nu / nu_k,
// whose divisor is the line's. Sets the event outputs as the generic loop.
// GEN: the 1D walk's generic loads (its line tables may lie in shared memory)
template <bool GEN, typename R>
__device__ __forceinline__ void line_walk_w64(const R* __restrict__ line_nu,
                                              const R* __restrict__ taurow,
                                              const int* __restrict__ jblue_of_line,
                                              R* __restrict__ jbrow, int njb, int nlines,
                                              int cursor0, bool rel, R nu, R dnudl, R tstart,
                                              R safe_chi, R tau_next, R abort_dist,
                                              R nu_cmf_abort, R e_over_nu, R& ev_edist,
                                              int& ev_ntr, bool& ev_bb, int& ev_lact) {
  constexpr R inv_c = R(1.0) / K<R>::CLIGHT;
  const R inv_dnudl = R(1.0) / dnudl;
  const R ct = K<R>::CLIGHT * tstart;
  R tau_cum = R(0.0), prevD = R(0.0);
  for (int l = cursor0;; ++l) {
    const R rem = tau_next - tau_cum;
    if (l > nlines - 1) {  // past the end of the list
      const R cd = r_max(rem / safe_chi, R(0.0));
      if (cd <= abort_dist) {
        ev_edist = cd;
        ev_ntr = nlines + 1;
      } else {
        ev_ntr = nlines - 1;
      }
      return;
    }
    const R nu_k = ld<GEN>(line_nu + l);
    R relD = rel ? (nu_k - nu) * inv_dnudl : ct * (nu / nu_k - R(1.0));
    relD = r_min(r_max(relD, R(0.0)), R(1e30));
    const R tau_line = ld<GEN>(taurow + l) * (tstart + prevD * inv_c);
    const R chi_d = safe_chi * relD;
    if (rem <= chi_d) {  // the continuum event comes first
      ev_edist = r_max(rem / safe_chi, R(0.0));
      ev_ntr = l;
      return;
    }
    if (nu_k < nu_cmf_abort) {
      ev_ntr = l;
      return;
    }
    if (njb) {  // a line passed, or the activating line (:1346-1363)
      const int col = __ldg(jblue_of_line + l);
      if (col >= 0 && col < njb) {
        atomicAdd(jbrow + col, (tstart + relD * inv_c) * e_over_nu);
        atomicAdd(jbrow + njb + col, R(1.0));
      }
    }
    if (rem <= chi_d + tau_line) {  // the line event
      ev_edist = relD;
      ev_ntr = l + 1;
      ev_bb = true;
      ev_lact = l;
      return;
    }
    tau_cum += tau_line;
    prevD = relD;
  }
}
template <typename R, int GEOM, bool EXPO, bool NLTE>
__host__ __device__ constexpr bool k4_redesign() {
  return EXPO && !NLTE && GEOM != GEOM_CART;
}

#ifdef RPKT_F64
// The bin walk of the redesigned double forms (K4 in double), from the
// packet's comoving frequency nu toward the red over the staged edge table
// (the plain version's float64 values, rpkt_kernel.expo_edges): the first
// bin found from a float estimate and corrected on the table, as the
// float32 walk finds it, and no divide by a divisor fixed for the crossing
// (1/dnudl taken once). Left in the loop: the non-relativistic nu / nu_lo,
// whose divisor is the bin's (a staged table of reciprocal edges won 0.5-2.4
// % on forced non-relativistic launches but cost the relativistic main
// path's replay 0.4 %: dropped, PERF.md section 6). Sets the event distance
// and the bound-bound split as the generic walk; counts the bins read into
// nwalk.
template <typename R>
__device__ __forceinline__ void bin_walk_w64(const R* __restrict__ edge,
                                             const R* __restrict__ krow, int nbins, bool rel,
                                             R nu, R dnudl, R tstart, R safe_chi, R rho_dop,
                                             R tau_next, R u_bb, R abort_dist, R& ev_edist,
                                             bool& ev_bb, int& nwalk) {
  const R inv_dnudl = R(1.0) / dnudl;
  const R ct = K<R>::CLIGHT * tstart;
  const float lam = __fdividef(2.99792458e18f, (float)nu);  // [A], an estimate
  int b = (int)fminf(fmaxf(floorf((lam - 534.5f) * (1.0f / 35.5f)), 0.0f), (float)nbins);
  while (b > 0 && edge[b - 1] < nu) --b;
  while (b < nbins && edge[b] >= nu) ++b;
  R cum = R(0.0), dprev = R(0.0);
  for (; b < nbins; ++b) {
    const R nu_lo = edge[b];
    R de = rel ? (nu_lo - nu) * inv_dnudl : ct * (nu / nu_lo - R(1.0));
    de = r_min(r_max(de, R(0.0)), R(1e30));
    const R seg = r_max(de - dprev, R(0.0));
    if (seg > R(0.0)) {
      ++nwalk;
      const R chi_bb = __ldg(krow + b) * rho_dop;
      const R chi_t = safe_chi + chi_bb;
      const R dtau = chi_t * seg;
      if (cum + dtau >= tau_next) {
        ev_edist = r_max(dprev + (tau_next - cum) / r_max(chi_t, R(1e-30)), R(0.0));
        ev_bb = u_bb <= chi_bb / r_max(chi_t, R(1e-30));
        return;
      }
      cum += dtau;
    }
    dprev = de;
    if (dprev > abort_dist) return;
  }
}
#endif

// elements of the table groups in ``stage`` (the 1D grid: one bound per
// cell), each in a slot of the launch's precision (an int table's entries
// too, 4-byte copies in 8-byte slots in double)
template <typename R>
__host__ __device__ inline int stage_words(const RpktParamsT<R>& p) {
  return ((p.stage & STAGE_CELL) ? 3 * p.nprop + 6 * p.ncells : 0) +
         ((p.stage & STAGE_BF) ? p.ncont * (3 + p.nphixs) + p.ngc : 0) +
         ((p.stage & STAGE_BFCELL) ? 2 * p.ncells * p.ncont : 0) +
         ((p.stage & STAGE_LINES) ? p.nlines * (1 + p.ncells) : 0);
}

// dynamic shared memory of a launch: the counters, the estimator rows in
// shared mode, and the staged tables of the redesigned 1D walk (K1) or the
// bin edges of the redesigned bin walk (K4)
template <typename R, int GEOM, bool EXPO, bool NLTE>
size_t smem_bytes(const RpktParamsT<R>& p) {
  constexpr bool R1 = k1_redesign<R, GEOM, EXPO, NLTE>(), R4 = k4_redesign<R, GEOM, EXPO, NLTE>();
  size_t b = NMISC * sizeof(double) + (p.shared_rows ? sizeof(R) * (size_t)p.ncells * p.nrow : 0);
  if (R1) b += sizeof(R) * (size_t)stage_words(p);
  if (R4) b += sizeof(R) * (size_t)p.nbins;
  return b;
}

// the crossing loop of one block (the kernels below)
template <typename R, int GEOM, bool EXPO, bool NLTE>
__device__ __forceinline__ void crossing(RpktParamsT<R> p, Lanes<R> in, Tables<R> tb,
                                         Outs<R> out) {
  constexpr bool R1 = k1_redesign<R, GEOM, EXPO, NLTE>(), R4 = k4_redesign<R, GEOM, EXPO, NLTE>();
  constexpr bool R3 = k3_redesign<R, GEOM, EXPO, NLTE>();
  constexpr bool GEN = R1;  // generic table loads: the tables may lie in shared memory
  extern __shared__ double smem_d[];
  double* s_misc = smem_d;
  const int nbfr = p.want_bfrate ? p.ncont : 0;
  // without NLTE the LUT estimators are on and the multibin and J_b_lu
  // rows are off at compile time
  const bool lut_g = !NLTE || p.want_gamma, lut_h = !NLTE || p.want_bfheat;
  const int ngam = lut_g ? p.ngc : 0, nbfh = lut_h ? p.ngc : 0;
  const int nrb = NLTE ? p.nradbins : 0, njb = (NLTE && !EXPO) ? p.njblue : 0;
  // estimator rows: this block's copy in shared memory, or the global rows
  R *a_est, *a_gam, *a_bfh, *a_bfr, *a_rb, *a_jb;
  if (p.shared_rows) {
    a_est = reinterpret_cast<R*>(smem_d + NMISC);
    a_gam = a_est + 4 * p.ncells;
    a_bfh = a_gam + p.ncells * ngam;
    a_bfr = a_bfh + p.ncells * nbfh;
    a_rb = a_bfr + p.ncells * nbfr;
    a_jb = a_rb + p.ncells * 3 * nrb;
    for (int i = threadIdx.x; i < p.ncells * p.nrow; i += blockDim.x) a_est[i] = R(0.0);
  } else {
    a_est = out.est;
    a_gam = out.gamma;
    a_bfh = out.bfheat;
    a_bfr = out.bfrate;
    a_rb = out.radbin;
    a_jb = out.jblue;
  }
  // past the rows: the K1 tables or the K4 edges
  R* s_free = reinterpret_cast<R*>(smem_d + NMISC) +
                  (p.shared_rows ? (size_t)p.ncells * p.nrow : 0);
  if constexpr (GEN) {
    // stage the groups the wrapper picked; the loads below are generic
    if (p.stage & STAGE_CELL) {
      int* s_mgi = reinterpret_cast<int*>(s_free);
      stage_copy(s_mgi, tb.mgi_of_cell, p.nprop);
      tb.mgi_of_cell = s_mgi;
      R* s = s_free + p.nprop;
      stage_copy(s, tb.cellmin, p.nprop);
      tb.cellmin = s;
      stage_copy(s + p.nprop, tb.cellmax, p.nprop);
      tb.cellmax = s + p.nprop;
      s += 2 * p.nprop;
      stage_copy(s, tb.nne, p.ncells);
      tb.nne = s;
      stage_copy(s + p.ncells, tb.te, p.ncells);
      tb.te = s + p.ncells;
      stage_copy(s + 2 * p.ncells, tb.kappagrey, p.ncells);
      tb.kappagrey = s + 2 * p.ncells;
      stage_copy(s + 3 * p.ncells, tb.rho, p.ncells);
      tb.rho = s + 3 * p.ncells;
      stage_copy(s + 4 * p.ncells, tb.chiffpart, p.ncells);
      tb.chiffpart = s + 4 * p.ncells;
      int* s_thick = reinterpret_cast<int*>(s + 5 * p.ncells);
      stage_copy(s_thick, tb.thick, p.ncells);
      tb.thick = s_thick;
      s_free = s + 6 * p.ncells;
    }
    if (p.stage & STAGE_BF) {
      stage_copy(s_free, tb.cont_nu_edge, p.ncont);
      tb.cont_nu_edge = s_free;
      stage_copy(s_free + p.ncont, tb.cont_prob, p.ncont);
      tb.cont_prob = s_free + p.ncont;
      int* s_gidx = reinterpret_cast<int*>(s_free + 2 * p.ncont);
      stage_copy(s_gidx, tb.cont_gidx, p.ncont);
      tb.cont_gidx = s_gidx;
      stage_copy(s_free + 3 * p.ncont, tb.cont_phixs, p.ncont * p.nphixs);
      tb.cont_phixs = s_free + 3 * p.ncont;
      s_free += p.ncont * (3 + p.nphixs);
      stage_copy(s_free, tb.gc_nu_edge, p.ngc);
      tb.gc_nu_edge = s_free;
      s_free += p.ngc;
    }
    if (p.stage & STAGE_BFCELL) {
      stage_copy(s_free, tb.bf_a, p.ncells * p.ncont);
      tb.bf_a = s_free;
      s_free += p.ncells * p.ncont;
      stage_copy(s_free, tb.bf_dep, p.ncells * p.ncont);
      tb.bf_dep = s_free;
      s_free += p.ncells * p.ncont;
    }
    if (p.stage & STAGE_LINES) {
      stage_copy(s_free, tb.line_nu, p.nlines);
      tb.line_nu = s_free;
      stage_copy(s_free + p.nlines, tb.tau_factor, p.ncells * p.nlines);
      tb.tau_factor = s_free + p.nlines;
    }
  }
  if constexpr (R4) {
    stage_copy(s_free, tb.expo_nu_lo, p.nbins);
    tb.expo_nu_lo = s_free;
  }
  for (int i = threadIdx.x; i < NMISC; i += blockDim.x) s_misc[i] = 0.0;
  if constexpr (GEN || R4) cp_async_wait_all();
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
#ifdef RPKT_F64
  // the double forms count in 32-bit integers (a lane's counts stay below
  // max_inner times the line list's length): seven registers fewer than
  // the float32 form's double and 64-bit counters, which left the double
  // forms spilling 14-42 bytes at 168 registers
  int m_nadv = 0, m_nesc = 0, m_escat = 0, m_thick = 0, m_cross = 0;
  int m_walk = 0, m_bfwin = 0;  // lines read by the walk, bf continua in windows
  double m_lum = 0.0;
#else
  double m_nadv = 0.0, m_nesc = 0.0, m_lum = 0.0, m_escat = 0.0, m_thick = 0.0, m_cross = 0.0;
  long long m_walk = 0, m_bfwin = 0;  // lines read by the walk, bf continua in windows
#endif
  if (lane < p.n) {
    const bool rel = p.relativistic != 0;
    const int nlines = p.nlines;
    R px = in.px[lane], py = in.py[lane], pz = in.pz[lane];
    R dx = in.dx[lane], dy = in.dy[lane], dz = in.dz[lane];
    // K3: the direction's xy terms, recomputed only where a scatter turns it
    XYDir<R> xyd{};
    if constexpr (R3) xyd = xy_dir(dx, dy);
    R nurf = in.nurf[lane], nucmf = in.nucmf[lane], erf = in.erf[lane], ecmf = in.ecmf[lane];
    R t = in.t[lane], terr = R(0.0);
    int cell = in.where[lane], ntr = in.next_trans[lane];
    bool moving = in.moving[lane] > 0;
    const uint32_t lane_id = (uint32_t)in.lane_id[lane];
    const R test_tau = in.test_tau[lane], test_sel = in.test_sel[lane];
    bool evented = false, escaped = false, ev_thick = false, ev_isbb = false, inkscat = false;
    int ev_act = -99, ev_bfidx = 0, ev_mgi = 0, nsc = 0;
    R ev_esc = R(0.0), ev_ff = R(0.0), ev_bf = R(0.0), ev_cont = R(0.0);
    R em_x = R(0.0), em_y = R(0.0), em_z = R(0.0), em_t = R(0.0);
    const R nu_lastline = ld<GEN>(tb.line_nu + nlines - 1);
    const R sigma_es = p.sigma_es;

    for (int it = 0; it < p.max_inner && moving; ++it) {
      const R tstart = t;
      const int mgi = ld<GEN>(tb.mgi_of_cell + cell);
      const bool nonempty = mgi >= 0;
      const int smgi = nonempty ? mgi : 0;
      const R nne_p = ld<GEN>(tb.nne + smgi), te_p = ld<GEN>(tb.te + smgi);
      const R kgrey_p = ld<GEN>(tb.kappagrey + smgi), rho_p = ld<GEN>(tb.rho + smgi);
      const R chiffpart_p = ld<GEN>(tb.chiffpart + smgi);
      const bool thick = nonempty && (ld<GEN>(tb.thick + smgi) == 1);

      R tau_next, sel_u, u_split, u_bb, z1, z2;
      if (p.test_mode) {
        tau_next = test_tau;
        sel_u = test_sel;
        u_split = test_sel;
        u_bb = test_sel;
        z1 = R(0.37);
        z2 = R(0.81);
      } else if constexpr (is_f32<R>) {
        float u[4], v[4];
        uniform4(lane_id, (uint32_t)it, 0u, p.seed_lo, p.seed_hi, u);
        uniform4(lane_id, (uint32_t)it, 1u, p.seed_lo, p.seed_hi, v);
        tau_next = -logf(u[0]);
        sel_u = u[1];
        z1 = u[2];
        z2 = u[3];
        u_split = v[0];
        u_bb = v[1];
      } else {  // float64: two uniforms a draw, three draws a crossing
        double u[2], z[2], v[2];
        uniform2d(lane_id, (uint32_t)it, 0u, p.seed_lo, p.seed_hi, u);
        uniform2d(lane_id, (uint32_t)it, 1u, p.seed_lo, p.seed_hi, z);
        uniform2d(lane_id, (uint32_t)it, 2u, p.seed_lo, p.seed_hi, v);
        tau_next = -log(u[0]);
        sel_u = u[1];
        z1 = z[0];
        z2 = z[1];
        u_split = v[0];
        u_bb = v[1];
      }

      // --- boundary distance of the grid geometry ---
      const R pos2 = px * px + py * py + pz * pz;
      const R pdotd = px * dx + py * dy + pz * dz;
      R sdist;
      int snext;
      boundary<GEOM, GEN, R3>(p, tb, cell, px, py, pz, dx, dy, dz, pos2, pdotd, tstart, sdist,
                              snext, xyd);
      const R tdist = r_max((p.t2 - tstart) * K<R>::CLIGHT, R(0.0));
      const R abort_dist = r_min(sdist, tdist);

      // --- Doppler + abort-point frequency (rpkt.cc:49-61) ---
      const R doppler = doppler_at(dx, dy, dz, px, py, pz, tstart, rel);
      const R atime = tstart + abort_dist / K<R>::CLIGHT;
      const R nu_cmf_abort = nurf * doppler_at(dx, dy, dz, px + dx * abort_dist,
                                                   py + dy * abort_dist, pz + dz * abort_dist,
                                                   atime, rel);
      R dnudl = (nu_cmf_abort - nucmf) / r_max(abort_dist, R(1e-30));
      if (!(dnudl < R(0.0))) dnudl = -R(1e-30);

      const bool need_chi = nonempty && !thick;
      const R nu = need_chi ? nucmf : R(1e15);

      // --- continuum opacities (rpkt.cc:972-1032) ---
      const R chi_escat = sigma_es * nne_p;
      const R nus = nu * R(8.8817841970012523e-16);  // 2^-50
      const R hnu_kt = K<R>::HOVERKB * nu / te_p;
      const R chi_ff = (chiffpart_p * R(2.6469779601696886e-23)) * (nne_p * R(2.6469779601696886e-23)) /
                           (nus * nus * nus) * (R(1.0) - r_exp(-hnu_kt));
      R chi_bf = R(0.0);
      int bf_lo = 0, bf_hi = 0;
      if (need_chi && p.ncont > 0) {
        bf_window<GEN>(tb.cont_nu_edge, p.ncont, nu, p.last_nuovernuedge, bf_lo, bf_hi);
        m_bfwin += bf_hi - bf_lo;
        for (int c = bf_lo; c < bf_hi; ++c) {
          const R edge = ld<GEN>(tb.cont_nu_edge + c);
          const R sigma = bf_sigma<GEN>(tb.cont_phixs + (size_t)c * p.nphixs, p.nphixs, nu,
                                            edge, p.phixs_dnu, p.last_nuovernuedge);
          const R dep = ld<GEN>(tb.bf_dep + (size_t)smgi * p.ncont + c);
          const R corr = r_max(R(0.0), R(1.0) - r_exp(r_min(r_max(dep - hnu_kt, -R(80.0)), R(80.0))));
          chi_bf += ld<GEN>(tb.bf_a + (size_t)smgi * p.ncont + c) * sigma * corr;
        }
      }
      const R chi_cont_cmf = chi_escat + chi_ff + chi_bf;
      const R chi_cont = chi_cont_cmf * doppler;

      R ev_edist = K<R>::BIG;
      int ev_ntr = ntr, ev_lact = -99;
      bool ev_bb = false;
      if (need_chi) {
        if constexpr (EXPO) {
          // --- binned expansion-opacity walk (rpkt.cc:199-290) ---
          ev_ntr = -1;  // no line cursor in this mode (pallas_rpkt.py:1198)
          const R safe_chi = r_max(chi_cont, R(1e-30));
          const R rho_dop = rho_p * doppler;
          const R* __restrict__ krow = tb.expo_kappa + (size_t)smgi * p.nbins;
          if constexpr (R4) {
#ifdef RPKT_F64
            bin_walk_w64(tb.expo_nu_lo, krow, p.nbins, rel, nu, dnudl, tstart, safe_chi,
                         rho_dop, tau_next, u_bb, abort_dist, ev_edist, ev_bb, m_walk);
#else
            // the edges from the staged table (the plain version's float32
            // values); the walk starts at the first bin whose lower edge lies
            // below nu, found from a float estimate and corrected on the table:
            // the bins before it have no path length
            const R* __restrict__ edge = tb.expo_nu_lo;
            int b = (int)r_min(r_max(r_floor((R(2.99792458e18) / nu - R(534.5)) / R(35.5)), R(0.0)),
                               (R)p.nbins);
            while (b > 0 && edge[b - 1] < nu) --b;
            while (b < p.nbins && edge[b] >= nu) ++b;
            R cum = R(0.0), dprev = R(0.0);
            for (; b < p.nbins; ++b) {
              const R nu_lo = edge[b];
              R de = rel ? (nu_lo - nu) / dnudl : K<R>::CLIGHT * tstart * (nu / nu_lo - R(1.0));
              de = r_min(r_max(de, R(0.0)), R(1e30));
              const R seg = r_max(de - dprev, R(0.0));
              if (seg > R(0.0)) {
                ++m_walk;
                const R kap = __ldg(krow + b);
                const R chi_bb = kap * rho_dop;
                const R chi_t = safe_chi + chi_bb;
                const R dtau = chi_t * seg;
                if (cum + dtau >= tau_next) {
                  ev_edist = r_max(dprev + (tau_next - cum) / r_max(chi_t, R(1e-30)), R(0.0));
                  ev_bb = u_bb <= chi_bb / r_max(chi_t, R(1e-30));
                  break;
                }
                cum += dtau;
              }
              dprev = de;
              if (dprev > abort_dist) break;
            }
#endif
          } else {
          // start one bin bluer than the packet's own (a guard against the
          // rounding of the estimate): bins bluer than the packet have no path
          // length, so starting early changes nothing
          const double lam = CLIGHT_ANGSTROM / (double)nu;
          const double bin_est = fmin((lam - LAMBDA_MIN_A) / DELTA_LAMBDA_A, (double)p.nbins);
          R cum = R(0.0), dprev = R(0.0);
          for (int b = max((int)floor(bin_est) - 1, 0); b < p.nbins; ++b) {
            const R nu_lo =
                (R)(CLIGHT_ANGSTROM / (LAMBDA_MIN_A + (double)(b + 1) * DELTA_LAMBDA_A));
            R de = rel ? (nu_lo - nu) / dnudl : K<R>::CLIGHT * tstart * (nu / nu_lo - R(1.0));
            de = r_min(r_max(de, R(0.0)), R(1e30));
            const R seg = r_max(de - dprev, R(0.0));
            if (seg > R(0.0)) {
              ++m_walk;
              const R chi_bb = __ldg(krow + b) * rho_dop;
              const R chi_t = safe_chi + chi_bb;
              const R dtau = chi_t * seg;
              if (cum + dtau >= tau_next) {
                ev_edist = r_max(dprev + (tau_next - cum) / r_max(chi_t, R(1e-30)), R(0.0));
                ev_bb = u_bb <= chi_bb / r_max(chi_t, R(1e-30));
                break;
              }
              cum += dtau;
            }
            dprev = de;
            // an event past the abort distance lies beyond the boundary or the
            // time limit and is never taken: the walk may stop here
            if (dprev > abort_dist) break;
          }
          }
        } else {
          // --- Sobolev line walk from the packet's cursor (rpkt.cc:77-197) ---
          int cursor0;
          if (ntr > nlines - 1 || nu < nu_lastline) {
            cursor0 = nlines;
          } else if (ntr > 0) {
            cursor0 = min(ntr, nlines);
          } else {  // fresh cursor: count of lines bluer than nu
            int a = 0, b = nlines;
            while (a < b) {
              const int m = (a + b) >> 1;
              if (ld<GEN>(tb.line_nu + m) > nu) a = m + 1; else b = m;
            }
            cursor0 = a;
          }
          const R safe_chi = r_max(chi_cont, R(1e-30));
          if (cursor0 >= nlines) {
            const R cd = r_max(tau_next / safe_chi, R(0.0));
            if (cd <= abort_dist) {
              ev_edist = cd;
              ev_ntr = nlines + 1;
            }
          } else {
            const R* __restrict__ taurow = tb.tau_factor + (size_t)smgi * nlines;
            R* __restrict__ jbrow = a_jb + (size_t)smgi * 2 * njb;
            // c e_cmf / nu_cmf is invariant along the free flight
            // (pallas_rpkt.py:1255-1262)
            const R e_over_nu = njb ? K<R>::CLIGHT * ecmf / r_max(nu, R(1.0)) : R(0.0);
#ifdef RPKT_F64
            // the redesigned double walks take their own loop; the guard
            // keeps the float32 unit's source, and so its SASS, the parent's
            if constexpr (w64_redesign<R, GEOM, EXPO, NLTE>()) {
              line_walk_w64<GEN>(tb.line_nu, taurow, tb.jblue_of_line, jbrow, njb, nlines,
                                 cursor0, rel, nu, dnudl, tstart, safe_chi, tau_next, abort_dist,
                                 nu_cmf_abort, e_over_nu, ev_edist, ev_ntr, ev_bb, ev_lact);
            } else {
#endif
            R tau_cum = R(0.0), prevD = R(0.0);
            for (int l = cursor0;; ++l) {
              if (l > nlines - 1) {  // past the end of the list
                const R cd = r_max((tau_next - tau_cum) / safe_chi, R(0.0));
                if (cd <= abort_dist) {
                  ev_edist = cd;
                  ev_ntr = nlines + 1;
                } else {
                  ev_ntr = nlines - 1;
                }
                break;
              }
              const R nu_k = ld<GEN>(tb.line_nu + l);
              R relD = rel ? (nu_k - nu) / dnudl : K<R>::CLIGHT * tstart * (nu / nu_k - R(1.0));
              relD = r_min(r_max(relD, R(0.0)), R(1e30));
              const R t_prev = tstart + prevD / K<R>::CLIGHT;
              const R tau_line = ld<GEN>(taurow + l) * t_prev;
              const R contdist = r_max((tau_next - tau_cum) / safe_chi, R(0.0));
              if (contdist <= relD) {
                ev_edist = contdist;
                ev_ntr = l;
                break;
              }
              if (nu_k < nu_cmf_abort) {
                ev_ntr = l;
                break;
              }
              const bool line_event = tau_next - tau_cum <= safe_chi * relD + tau_line;
              if (njb) {  // a line passed, or the activating line (:1346-1363)
                const int col = __ldg(tb.jblue_of_line + l);
                if (col >= 0 && col < njb) {
                  const R t_line = tstart + relD / K<R>::CLIGHT;
                  atomicAdd(jbrow + col, t_line * e_over_nu);
                  atomicAdd(jbrow + njb + col, R(1.0));
                }
              }
              if (line_event) {
                ev_edist = relD;
                ev_ntr = l + 1;
                ev_bb = true;
                ev_lact = l;
                break;
              }
              tau_cum += tau_line;
              prevD = relD;
            }
#ifdef RPKT_F64
            }
#endif
          }
          m_walk += max(0, min(ev_ntr, nlines) - cursor0);
        }
      }

      // thick cells: grey opacity (rpkt.cc:647-654)
      R edist;
      int next_trans;
      if (thick) {
        edist = tau_next / r_max(kgrey_p * rho_p * doppler, R(1e-30));
        next_trans = -1;
      } else if (nonempty) {
        edist = ev_edist;
        next_trans = ev_ntr;
      } else {
        edist = K<R>::BIG;
        next_trans = -1;
      }
      const bool is_bb = !thick && nonempty && ev_bb;
      const bool take_boundary = (sdist <= tdist) && (sdist <= edist);
      bool take_event = !take_boundary && (edist <= tdist);
      const bool take_tlimit = !take_boundary && !take_event;
      // the boundary overshoot: float32 only, as the XLA path's
      R dist = take_boundary ? sdist + (is_f32<R> ? R(3e-6) * r_sqrt(pos2) : R(0.0))
                             : (take_event ? edist : tdist);
      dist = r_max(dist, R(0.0));

      // in-kernel isotropic scattering: electron scattering and thick grey;
      // in the deferred mode (K6, dipole scattering) every event, these
      // two included, leaves the loop for the event pass
      const bool ink = p.defer_scatter == 0;
      const bool is_escat = ink && take_event && !thick && !is_bb && nonempty &&
                            (u_split * chi_cont_cmf < chi_escat);
      const bool ev_thick_k = ink && take_event && thick;
      const bool scat = is_escat || ev_thick_k;
      take_event = take_event && !scat;

      // --- two half-moves with midpoint estimators (rpkt.cc:676-727) ---
      const R h = dist * R(0.5);
      const R mx = px + dx * h, my = py + dy * h, mz = pz + dz * h;
      const R mt = tstart + h / K<R>::CLIGHT;
      const R dop_mid = doppler_at(dx, dy, dz, mx, my, mz, mt, rel);
      const R nucmf1 = r_min(nurf * dop_mid, nucmf);
      const R ecmf1 = erf * dop_mid;
      const bool crossing = take_boundary && snext >= 0;
      if (nonempty) {
        const R contrib = dist * ecmf1;
        if constexpr (R1) {
          est_add_warp(a_est + 4 * mgi, mgi, contrib, contrib * nucmf1,
                       thick ? R(0.0) : contrib * chi_ff, crossing ? R(1.0) : R(0.0));
        } else if (R3 && !p.shared_rows) {
          // K3: the cell's four floats in one vector reduction (the global
          // rows are 16-byte aligned, rpkt_kernel.estimator_buffers)
          red_add_v4(a_est + 4 * mgi, contrib, contrib * nucmf1, thick ? R(0.0) : contrib * chi_ff,
                     crossing ? R(1.0) : R(0.0));
        } else {
          atomicAdd(a_est + 4 * mgi + 0, contrib);
          atomicAdd(a_est + 4 * mgi + 1, contrib * nucmf1);
          if (!thick) atomicAdd(a_est + 4 * mgi + 2, contrib * chi_ff);
          if (crossing) atomicAdd(a_est + 4 * mgi + 3, R(1.0));
        }
        if (nrb && nucmf1 >= p.rb_lo && nucmf1 < p.rb_super) {
          // multibin J / nuJ / count at the midpoint (pallas_rpkt.py:1491-1514)
          R bsel = r_floor((nucmf1 - p.rb_lo) / p.rb_delta);
          if (nucmf1 >= p.rb_last) bsel = (R)(nrb - 1);
          const int b = (int)r_min(r_max(bsel, R(0.0)), (R)(nrb - 1));
          R* rbrow = a_rb + (size_t)mgi * 3 * nrb;
          atomicAdd(rbrow + b, contrib);
          atomicAdd(rbrow + nrb + b, contrib * nucmf1);
          atomicAdd(rbrow + 2 * nrb + b, R(1.0));
        }
        if (!thick && bf_hi > bf_lo) {
          // per-ground-continuum sigma*prob*corr (rpkt.cc:870-880), the
          // detailed per-continuum bf-rate (radfield.cc:204-233, weight
          // contrib / nu_cmf * doppler at the segment-start frequency) and
          // the continuum selection draw (rpkt.cc:469-474), one pass
          const R nuc1 = r_max(nucmf1, R(1e-30));
          const R w_bfr = contrib / nuc1 * doppler;
          const R target = sel_u * chi_bf;
          R cum = R(0.0);
          int bf_idx = -1;
          for (int c = bf_lo; c < bf_hi; ++c) {
            const R edge = ld<GEN>(tb.cont_nu_edge + c);
            const R sigma = bf_sigma<GEN>(tb.cont_phixs + (size_t)c * p.nphixs, p.nphixs, nu,
                                              edge, p.phixs_dnu, p.last_nuovernuedge);
            const R dep = ld<GEN>(tb.bf_dep + (size_t)smgi * p.ncont + c);
            const R corr = r_max(R(0.0), R(1.0) - r_exp(r_min(r_max(dep - hnu_kt, -R(80.0)), R(80.0))));
            cum += ld<GEN>(tb.bf_a + (size_t)smgi * p.ncont + c) * sigma * corr;
            if (bf_idx < 0 && cum > target) bf_idx = c;
            const int g = (lut_g || lut_h) ? ld<GEN>(tb.cont_gidx + c) : -1;
            if (g >= 0) {
              const R de = contrib * sigma * corr * ld<GEN>(tb.cont_prob + c);
              if (lut_g) atomicAdd(a_gam + mgi * ngam + g, de / nuc1);
              if (lut_h)
                atomicAdd(a_bfh + mgi * nbfh + g,
                          de * r_max(R(1.0) - ld<GEN>(tb.gc_nu_edge + g) / nuc1, R(0.0)));
            }
            if (nbfr) atomicAdd(a_bfr + (size_t)mgi * nbfr + c,
                                sigma * corr * ld<GEN>(tb.cont_prob + c) * w_bfr);
          }
          if (take_event) ev_bfidx = bf_idx < 0 ? 0 : bf_idx;
        } else if (take_event) {
          ev_bfidx = 0;
        }
      } else if (take_event) {
        ev_bfidx = 0;
      }

      // second half-move
      const R fx = mx + dx * h, fy = my + dy * h, fz = mz + dz * h;
      const R ft = mt + h / K<R>::CLIGHT;
      const R dop2 = doppler_at(dx, dy, dz, fx, fy, fz, ft, rel);
      const R nucmf2 = r_min(nurf * dop2, nucmf1);
      const R ecmf2 = erf * dop2;
      if constexpr (is_f32<R>) {
        // compensated t += dist/c: diffusion steps fall below the float32 ulp of t
        const float kah_y = dist / K<R>::CLIGHT - terr;
        const float kah_t = tstart + kah_y;
        const float kah_err = __fsub_rn(__fsub_rn(kah_t, tstart), kah_y);
        if (take_tlimit) {
          t = p.t2;
          terr = 0.0f;
        } else {
          t = kah_t;
          terr = kah_err;
        }
      } else {
        // float64: the two half-moves' time, as the XLA path's move_pkt
        t = take_tlimit ? p.t2 : ft;
      }
      px = fx;
      py = fy;
      pz = fz;
      nucmf = nucmf2;
      ecmf = ecmf2;
      if (!thick && nonempty) ntr = next_trans;
      if (!nonempty) ntr = -1;
      const bool escaping = take_boundary && snext == BOUNDARY_ESCAPE;
      if (crossing) cell = snext;

      if (scat) {  // isotropic cmf re-emission at the post-move position (rpkt.cc:945-970)
        const R zmu = R(2.0) * z1 - R(1.0);
        const R zphi = R(6.2831853071795862) * z2;
        const R sinm = r_sqrt(r_max(R(1.0) - zmu * zmu, R(0.0)));
        const R cdx = sinm * r_cos(zphi), cdy = sinm * r_sin(zphi), cdz = zmu;
        const R inv_t = R(1.0) / ft;
        const R vx = -fx * inv_t, vy = -fy * inv_t, vz = -fz * inv_t;
        const R vsqr = (vx * vx + vy * vy + vz * vz) / K<R>::CLIGHTSQUARED;
        const R grel = R(1.0) / r_sqrt(r_max(R(1.0) - vsqr, R(1e-30)));
        const R ndotv = cdx * vx + cdy * vy + cdz * vz;
        const R fact1 = grel * (R(1.0) - ndotv / K<R>::CLIGHT);
        const R fact2 = (grel - grel * grel * ndotv / (grel + R(1.0)) / K<R>::CLIGHT) / K<R>::CLIGHT;
        R ndx = (cdx - vx * fact2) / fact1, ndy = (cdy - vy * fact2) / fact1,
              ndz = (cdz - vz * fact2) / fact1;
        const R nlen = r_sqrt(ndx * ndx + ndy * ndy + ndz * ndz);
        ndx /= nlen;
        ndy /= nlen;
        ndz /= nlen;
        const R dop_sc = doppler_at(ndx, ndy, ndz, fx, fy, fz, ft, rel);
        dx = ndx;
        dy = ndy;
        dz = ndz;
        if constexpr (R3) xyd = xy_dir(dx, dy);
        nurf = nucmf / dop_sc;
        erf = ecmf / dop_sc;
        em_x = fx;
        em_y = fy;
        em_z = fz;
        em_t = ft;
        nsc += 1;
        inkscat = true;
      }
      if (take_event) {
        evented = true;
        ev_thick = thick;
        ev_isbb = is_bb;
        ev_act = ev_lact;
        ev_esc = chi_escat;
        ev_ff = chi_ff;
        ev_bf = chi_bf;
        ev_cont = chi_cont_cmf;
        ev_mgi = mgi;
      }
      escaped = escaped || escaping;
      moving = !take_event && !take_tlimit && !escaping;
#ifdef RPKT_F64
      ++m_nadv;
      if (escaping) {
        ++m_nesc;
        m_lum += ecmf;
      }
      m_escat += is_escat;
      m_thick += ev_thick_k;
      m_cross += crossing;
#else
      m_nadv += 1.0;
      if (escaping) {
        m_nesc += 1.0;
        m_lum += (double)ecmf;
      }
      if (is_escat) m_escat += 1.0;
      if (ev_thick_k) m_thick += 1.0;
      if (crossing) m_cross += 1.0;
#endif
    }

    out.px[lane] = px; out.py[lane] = py; out.pz[lane] = pz;
    out.dx[lane] = dx; out.dy[lane] = dy; out.dz[lane] = dz;
    out.nurf[lane] = nurf; out.nucmf[lane] = nucmf; out.erf[lane] = erf; out.ecmf[lane] = ecmf;
    out.t[lane] = t;
    out.chi_escat[lane] = ev_esc; out.chi_ff[lane] = ev_ff; out.chi_bf[lane] = ev_bf;
    out.chi_cont[lane] = ev_cont;
    out.em_x[lane] = em_x; out.em_y[lane] = em_y; out.em_z[lane] = em_z; out.em_t[lane] = em_t;
    out.where[lane] = cell; out.next_trans[lane] = ntr;
    out.evented[lane] = evented; out.escaped[lane] = escaped; out.thick[lane] = ev_thick;
    out.is_bb[lane] = ev_isbb; out.act_line[lane] = ev_act; out.bf_idx[lane] = ev_bfidx;
    out.mgi[lane] = ev_mgi; out.nsc[lane] = nsc; out.inkscat[lane] = inkscat;
  }
  if (m_nadv != 0.0) {
    atomicAdd(s_misc + 0, m_nadv);
    atomicAdd(s_misc + 1, m_nesc);
    atomicAdd(s_misc + 2, m_lum);
    atomicAdd(s_misc + 3, m_escat);
    atomicAdd(s_misc + 4, m_thick);
    atomicAdd(s_misc + 5, m_cross);
    atomicAdd(s_misc + 6, (double)m_walk);
    atomicAdd(s_misc + 7, (double)m_bfwin);
  }
  __syncthreads();
  if (p.shared_rows) {
    for (int i = threadIdx.x; i < 4 * p.ncells; i += blockDim.x)
      if (a_est[i] != R(0.0)) atomicAdd(out.est + i, a_est[i]);
    for (int i = threadIdx.x; i < p.ncells * ngam; i += blockDim.x)
      if (a_gam[i] != R(0.0)) atomicAdd(out.gamma + i, a_gam[i]);
    for (int i = threadIdx.x; i < p.ncells * nbfh; i += blockDim.x)
      if (a_bfh[i] != R(0.0)) atomicAdd(out.bfheat + i, a_bfh[i]);
    for (int i = threadIdx.x; i < p.ncells * nbfr; i += blockDim.x)
      if (a_bfr[i] != R(0.0)) atomicAdd(out.bfrate + i, a_bfr[i]);
    for (int i = threadIdx.x; i < p.ncells * 3 * nrb; i += blockDim.x)
      if (a_rb[i] != R(0.0)) atomicAdd(out.radbin + i, a_rb[i]);
    for (int i = threadIdx.x; i < p.ncells * 2 * njb; i += blockDim.x)
      if (a_jb[i] != R(0.0)) atomicAdd(out.jblue + i, a_jb[i]);
  }
  for (int i = threadIdx.x; i < NMISC; i += blockDim.x)
    if (s_misc[i] != 0.0) atomicAdd(out.misc + i, s_misc[i]);
}

template <typename R, int GEOM, bool EXPO, bool NLTE>
__global__ void __launch_bounds__(BLOCK) rpkt_crossing_kernel(RpktParamsT<R> p, Lanes<R> in,
                                                              Tables<R> tb, Outs<R> out) {
  crossing<R, GEOM, EXPO, NLTE>(p, in, tb, out);
}

// the redesigned 1D line walk, with a register bound of its own (float32;
// the double form runs in the generic kernel, which its replayed main paths
// ran fastest)
template <typename R>
__global__ void __launch_bounds__(BLOCK, K1_MIN_BLOCKS)
    rpkt_crossing_kernel_1d(RpktParamsT<R> p, Lanes<R> in, Tables<R> tb, Outs<R> out) {
  crossing<R, GEOM_SPH, false, false>(p, in, tb, out);
}

template <typename R, int GEOM, bool EXPO, bool NLTE>
cudaError_t launch(const RpktParamsT<R>& p, const Lanes<R>& in, const Tables<R>& tb,
                   const Outs<R>& out, cudaStream_t stream) {
  const size_t smem = smem_bytes<R, GEOM, EXPO, NLTE>(p);
  // the largest dynamic shared memory this instantiation was allowed so far
  // (48 KB without asking): raised only when a launch needs more
  void (*kern)(RpktParamsT<R>, Lanes<R>, Tables<R>, Outs<R>);
  if constexpr (k1_redesign<R, GEOM, EXPO, NLTE>() && is_f32<R>) kern = rpkt_crossing_kernel_1d<R>;
  else kern = rpkt_crossing_kernel<R, GEOM, EXPO, NLTE>;
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const int grid = (p.n + BLOCK - 1) / BLOCK;
  kern<<<grid, BLOCK, smem, stream>>>(p, in, tb, out);
  return cudaGetLastError();
}

// the instantiation of a geometry: bin or line walk, with or without the
// NLTE estimator fields. The 3D line walk always takes the one with them:
// compiled so it ran 30 % faster than without them on the same work (an
// H100 at N=65536, max_inner=64, the 16^3 model's tables, in-kernel and
// deferred scattering; chip_smoke.py --kernel-ab), while the 1D and
// cylindrical line walks ran 40-55 % slower with them. The double forms
// take the same eleven instantiations of the generic kernel.
template <typename R, int GEOM>
cudaError_t launch_geom(const RpktParamsT<R>& p, const Lanes<R>& in, const Tables<R>& tb,
                        const Outs<R>& out, cudaStream_t st) {
  const bool nlte = p.nradbins || p.njblue || !p.want_gamma || !p.want_bfheat;
  if (p.expansion)
    return nlte ? launch<R, GEOM, true, true>(p, in, tb, out, st)
                : launch<R, GEOM, true, false>(p, in, tb, out, st);
  if constexpr (GEOM == GEOM_CART) {
    return launch<R, GEOM, false, true>(p, in, tb, out, st);
  } else {
    return nlte ? launch<R, GEOM, false, true>(p, in, tb, out, st)
                : launch<R, GEOM, false, false>(p, in, tb, out, st);
  }
}

// a launch in precision R from the entry point's pointer arrays
template <typename R>
int launch_real(const RpktParamsT<R>& p, void** lanes, void** tables, void** outs,
                void* stream) {
  const R* const* lf = reinterpret_cast<const R* const*>(lanes);
  Lanes<R> in{lf[0], lf[1], lf[2], lf[3], lf[4], lf[5], lf[6], lf[7], lf[8], lf[9], lf[10],
              reinterpret_cast<const int*>(lanes[11]), reinterpret_cast<const int*>(lanes[12]),
              reinterpret_cast<const int*>(lanes[13]), reinterpret_cast<const int*>(lanes[14]),
              lf[15], lf[16]};
  const R* const* tf = reinterpret_cast<const R* const*>(tables);
  Tables<R> tb{tf[0], tf[1], tf[2], tf[3], tf[4], tf[5], tf[6], tf[7], tf[8], tf[9], tf[10],
               tf[11], tf[12], tf[13], tf[14], tf[15], reinterpret_cast<const int*>(tables[16]),
               reinterpret_cast<const int*>(tables[17]), reinterpret_cast<const int*>(tables[18]),
               reinterpret_cast<const int*>(tables[19]), tf[20]};
  R* const* of = reinterpret_cast<R* const*>(outs);
  int* const* oi = reinterpret_cast<int* const*>(outs + 19);
  Outs<R> out{of[0], of[1], of[2], of[3], of[4], of[5], of[6], of[7], of[8], of[9], of[10],
              of[11], of[12], of[13], of[14], of[15], of[16], of[17], of[18],
              oi[0], oi[1], oi[2], oi[3], oi[4], oi[5], oi[6], oi[7], oi[8], oi[9], oi[10],
              reinterpret_cast<R*>(outs[30]), reinterpret_cast<R*>(outs[31]),
              reinterpret_cast<R*>(outs[32]), reinterpret_cast<R*>(outs[33]),
              reinterpret_cast<R*>(outs[34]), reinterpret_cast<R*>(outs[35]),
              reinterpret_cast<double*>(outs[36])};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p.geom) {
    case GEOM_SPH: return (int)launch_geom<R, GEOM_SPH>(p, in, tb, out, st);
    case GEOM_CYL: return (int)launch_geom<R, GEOM_CYL>(p, in, tb, out, st);
    case GEOM_CART: return (int)launch_geom<R, GEOM_CART>(p, in, tb, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points, bound with ctypes: one library of float32
// instantiations (rpkt_crossing_launch) and, built from this source with
// -DRPKT_F64, one of their double forms (rpkt_crossing_launch_f64). Pointer
// arrays follow the order of LANE_F32 + LANE_I32 + (test_tau, test_sel),
// TABLES_F32 + TABLES_I32 + (the bin edges) and OUT_F32 + OUT_I32 + (est,
// gamma, bfheat, bfrate, radbin, jblue, misc) in rpkt_kernel.py, the float
// arrays in the launch's precision. Launches on the given stream without
// synchronising; returns cudaGetLastError() (cudaErrorInvalidValue for an
// unknown geometry).
#ifndef RPKT_F64
extern "C" int rpkt_crossing_launch(const RpktParamsT<float>* prm, void** lanes, void** tables,
                                    void** outs, void* stream) {
  return launch_real<float>(*prm, lanes, tables, outs, stream);
}
#else
extern "C" int rpkt_crossing_launch_f64(const RpktParamsT<double>* prm, void** lanes,
                                        void** tables, void** outs, void* stream) {
  return launch_real<double>(*prm, lanes, tables, outs, stream);
}
#endif
