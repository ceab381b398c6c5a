// Native host runtime for chargeflux_tpu.
//
// The reference implements its entire runtime in C++/CUDA; this engine's
// hot path is XLA, and this library supplies the host-side native
// services around it:
//
//   * cell-list statistics (histogram / max occupancy) for capacity
//     planning at million-atom scale, replacing the role of OpenMM's
//     host-side neighbor machinery (ReferenceCoulKernels.cpp:559);
//   * a double-precision native oracle for the full charge-flux Ewald
//     energy/forces (the "reference platform" of this engine, mirroring
//     platforms/reference/src/ReferenceCoulKernels.cpp:424-636 semantics)
//     usable at scales where a Python oracle is too slow.
//
// Plain C ABI for ctypes; no external dependencies.

#include <algorithm>
#include <cmath>
#include <complex>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

inline void min_image(double* d, const double* box) {
    for (int k = 0; k < 3; ++k) d[k] -= box[k] * std::floor(d[k] / box[k] + 0.5);
}

}  // namespace

extern "C" {

// --- cell statistics ------------------------------------------------------

// counts: out int32[gx*gy*gz]; returns max occupancy.
int cf_cell_histogram(const double* pos, int64_t n, const double* box,
                      const int32_t* grid, int32_t* counts) {
    const int gx = grid[0], gy = grid[1], gz = grid[2];
    const int64_t ncell = (int64_t)gx * gy * gz;
    std::memset(counts, 0, ncell * sizeof(int32_t));
    for (int64_t i = 0; i < n; ++i) {
        int c[3];
        for (int k = 0; k < 3; ++k) {
            double f = pos[3 * i + k] / box[k];
            f -= std::floor(f);
            int idx = (int)(f * grid[k]);
            if (idx >= grid[k]) idx = grid[k] - 1;
            if (idx < 0) idx = 0;
            c[k] = idx;
        }
        counts[((int64_t)c[0] * gy + c[1]) * gz + c[2]]++;
    }
    int mx = 0;
    for (int64_t i = 0; i < ncell; ++i) mx = counts[i] > mx ? counts[i] : mx;
    return mx;
}

// --- native double-precision oracle --------------------------------------
//
// Computes effective charges, total energy, and forces (including the
// dE/dq dq/dx chain rule) for the periodic Ewald system.  Semantics follow
// the physics contract of the reference CPU kernel.  Intended for
// validation, not speed-of-light (O(N^2) direct loop with cutoff check).

void cf_flux_charges(const double* pos, int64_t n, const double* box, int pbc,
                     const double* q0,
                     const int32_t* bond_idx, const double* bond_kb, int64_t nb,
                     const int32_t* ang_idx, const double* ang_kt, int64_t na,
                     const int32_t* wat_idx, const double* wat_p, int64_t nw,
                     double* q_out) {
    for (int64_t i = 0; i < n; ++i) q_out[i] = q0[i];
    for (int64_t b = 0; b < nb; ++b) {
        int p1 = bond_idx[2 * b], p2 = bond_idx[2 * b + 1];
        double d[3];
        for (int k = 0; k < 3; ++k) d[k] = pos[3 * p2 + k] - pos[3 * p1 + k];
        if (pbc) min_image(d, box);
        double r = std::sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
        double dq = bond_kb[2 * b] * (r - bond_kb[2 * b + 1]);
        q_out[p1] += dq;
        q_out[p2] -= dq;
    }
    for (int64_t a = 0; a < na; ++a) {
        int p1 = ang_idx[3 * a], p2 = ang_idx[3 * a + 1], p3 = ang_idx[3 * a + 2];
        double d21[3], d23[3], d13[3];
        for (int k = 0; k < 3; ++k) {
            d21[k] = pos[3 * p1 + k] - pos[3 * p2 + k];
            d23[k] = pos[3 * p3 + k] - pos[3 * p2 + k];
            d13[k] = pos[3 * p3 + k] - pos[3 * p1 + k];
        }
        if (pbc) { min_image(d21, box); min_image(d23, box); min_image(d13, box); }
        double r21 = std::sqrt(d21[0]*d21[0]+d21[1]*d21[1]+d21[2]*d21[2]);
        double r23 = std::sqrt(d23[0]*d23[0]+d23[1]*d23[1]+d23[2]*d23[2]);
        double r13_2 = d13[0]*d13[0]+d13[1]*d13[1]+d13[2]*d13[2];
        double cost = (r23 * r23 + r21 * r21 - r13_2) / (2.0 * r21 * r23);
        if (cost > 1.0) cost = 1.0;
        if (cost < -1.0) cost = -1.0;
        double dq = ang_kt[2 * a] * (std::acos(cost) - ang_kt[2 * a + 1]);
        q_out[p1] += dq;
        q_out[p3] += dq;
        q_out[p2] -= 2.0 * dq;
    }
    for (int64_t w = 0; w < nw; ++w) {
        int pO = wat_idx[3 * w], pH1 = wat_idx[3 * w + 1], pH2 = wat_idx[3 * w + 2];
        const double k1 = wat_p[5 * w], k2 = wat_p[5 * w + 1], kub = wat_p[5 * w + 2];
        const double b0 = wat_p[5 * w + 3], ub0 = wat_p[5 * w + 4];
        double d12[3], d13[3], d23[3];
        for (int k = 0; k < 3; ++k) {
            d12[k] = pos[3 * pH1 + k] - pos[3 * pO + k];
            d13[k] = pos[3 * pH2 + k] - pos[3 * pO + k];
            d23[k] = pos[3 * pH2 + k] - pos[3 * pH1 + k];
        }
        if (pbc) { min_image(d12, box); min_image(d13, box); min_image(d23, box); }
        double r12 = std::sqrt(d12[0]*d12[0]+d12[1]*d12[1]+d12[2]*d12[2]);
        double r13 = std::sqrt(d13[0]*d13[0]+d13[1]*d13[1]+d13[2]*d13[2]);
        double r23 = std::sqrt(d23[0]*d23[0]+d23[1]*d23[1]+d23[2]*d23[2]);
        double dq2 = k1 * (r12 - b0) + k2 * (r13 - b0) + kub * (r23 - ub0);
        double dq3 = k1 * (r13 - b0) + k2 * (r12 - b0) + kub * (r23 - ub0);
        q_out[pO] += -dq2 - dq3;
        q_out[pH1] += dq2;
        q_out[pH2] += dq3;
    }
}

// Direct-space (erfc Coulomb + LJ) energy with cutoff, minus excluded pairs;
// O(N^2) loop.  sigma/epsilon are raw per-particle values; exclusion list is
// [p1,p2] pairs.  Returns energy; adds forces and dedq into the out arrays.
double cf_direct_energy(const double* pos, int64_t n, const double* box,
                        const double* q, const double* sigma, const double* eps,
                        const int32_t* excl, int64_t ne,
                        double cutoff, double alpha,
                        double* forces, double* dedq) {
    const double KE = 138.935456;
    const double TWOSQ = 2.0 / std::sqrt(M_PI);
    const double c2 = cutoff * cutoff;
    // exclusion bitmap via sorted key set
    std::vector<int64_t> keys(ne);
    for (int64_t e = 0; e < ne; ++e) {
        int64_t a = excl[2 * e], b = excl[2 * e + 1];
        if (a > b) { int64_t t = a; a = b; b = t; }
        keys[e] = a * n + b;
    }
    std::sort(keys.begin(), keys.end());
    auto excluded = [&](int64_t i, int64_t j) {
        int64_t k = i * n + j;
        return std::binary_search(keys.begin(), keys.end(), k);
    };
    double energy = 0.0;
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t j = i + 1; j < n; ++j) {
            double d[3];
            for (int k = 0; k < 3; ++k) d[k] = pos[3 * i + k] - pos[3 * j + k];
            min_image(d, box);
            double r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
            bool ex = excluded(i, j);
            if (ex) {
                // exclusion correction: -erf(ar)/r, unconditional
                double r = std::sqrt(r2), invr = 1.0 / r, ar = alpha * r;
                double qq = KE * q[i] * q[j];
                energy -= qq * invr * std::erf(ar);
                double dEdR = qq * invr * invr * invr *
                              (std::erf(ar) - ar * std::exp(-ar * ar) * TWOSQ);
                for (int k = 0; k < 3; ++k) {
                    forces[3 * i + k] -= dEdR * d[k];
                    forces[3 * j + k] += dEdR * d[k];
                }
                dedq[i] -= KE * q[j] * invr * std::erf(ar);
                dedq[j] -= KE * q[i] * invr * std::erf(ar);
                continue;
            }
            if (r2 >= c2) continue;
            double r = std::sqrt(r2), invr = 1.0 / r, ar = alpha * r;
            double sig = 0.5 * (sigma[i] + sigma[j]);
            double s2 = sig * invr; s2 *= s2;
            double s6 = s2 * s2 * s2;
            double e4 = 4.0 * std::sqrt(eps[i] * eps[j]);
            double qq = KE * q[i] * q[j];
            energy += qq * invr * std::erfc(ar) + e4 * s6 * (s6 - 1.0);
            double dEdR = qq * invr * invr * invr *
                          (std::erfc(ar) + ar * std::exp(-ar * ar) * TWOSQ);
            dEdR += e4 * s6 * (12.0 * s6 - 6.0) * invr * invr;
            for (int k = 0; k < 3; ++k) {
                forces[3 * i + k] += dEdR * d[k];
                forces[3 * j + k] -= dEdR * d[k];
            }
            dedq[i] += KE * q[j] * invr * std::erfc(ar);
            dedq[j] += KE * q[i] * invr * std::erfc(ar);
        }
    }
    return energy;
}


// Self term + brute-force half-space reciprocal sum (classical Ewald,
// ReferenceCoulKernels.cpp:500-556 semantics: kx in [0,kmax); for kx==0
// only half the (ky,kz) plane, every counted vector weighted x2 through
// the constant).  Per-atom phase factors exp(i m g x) are built by
// complex recursion per axis — one exp() per atom per axis instead of one
// cos/sin pair per (atom, k-vector) — which keeps the O(N*K) brute loop
// usable at the ~30k engine-parity scale.  Adds forces (fixed-charge
// part) and dE/dq into the out arrays; returns E_self + E_recip.
double cf_recip_self_energy(const double* pos, int64_t n, const double* box,
                            const double* q, const int32_t* kmax,
                            double alpha, double* forces, double* dedq) {
    const double KE = 138.935456;
    using cd = std::complex<double>;
    // self: E = -KE*alpha/sqrt(pi) * sum q^2
    const double sfac = -KE * alpha / std::sqrt(M_PI);
    double energy = 0.0;
    for (int64_t i = 0; i < n; ++i) {
        energy += sfac * q[i] * q[i];
        dedq[i] += 2.0 * sfac * q[i];
    }
    const int kmx = kmax[0], kmy = kmax[1], kmz = kmax[2];
    const double gx = 2.0 * M_PI / box[0], gy = 2.0 * M_PI / box[1],
                 gz = 2.0 * M_PI / box[2];
    const double vol = box[0] * box[1] * box[2];
    const double cfac = 4.0 * M_PI * KE / vol;
    const double inv4a2 = 1.0 / (4.0 * alpha * alpha);
    // phase tables for non-negative multiples; negative m uses conj
    std::vector<cd> ex((size_t)n * kmx), ey((size_t)n * kmy),
        ez((size_t)n * kmz), ph((size_t)n), pxy((size_t)n);
    for (int64_t i = 0; i < n; ++i) {
        const cd sx(std::cos(gx * pos[3 * i]), std::sin(gx * pos[3 * i]));
        const cd sy(std::cos(gy * pos[3 * i + 1]),
                    std::sin(gy * pos[3 * i + 1]));
        const cd sz(std::cos(gz * pos[3 * i + 2]),
                    std::sin(gz * pos[3 * i + 2]));
        cd ax(1.0, 0.0), ay(1.0, 0.0), az(1.0, 0.0);
        for (int m = 0; m < kmx; ++m) { ex[i * kmx + m] = ax; ax *= sx; }
        for (int m = 0; m < kmy; ++m) { ey[i * kmy + m] = ay; ay *= sy; }
        for (int m = 0; m < kmz; ++m) { ez[i * kmz + m] = az; az *= sz; }
    }
    int lo_y = 0, lo_z = 1;
    for (int mx = 0; mx < kmx; ++mx) {
        const double kx = mx * gx;
        for (int my = lo_y; my < kmy; ++my) {
            const double ky = my * gy;
            // x*y phase, hoisted out of the z loop
            for (int64_t i = 0; i < n; ++i) {
                const cd py = my >= 0 ? ey[i * kmy + my]
                                      : std::conj(ey[i * kmy - my]);
                pxy[i] = ex[i * kmx + mx] * py;
            }
            for (int mz = lo_z; mz < kmz; ++mz) {
                const double kz = mz * gz;
                const double k2 = kx * kx + ky * ky + kz * kz;
                const double eak = std::exp(-k2 * inv4a2) / k2;
                cd S(0.0, 0.0);
                for (int64_t i = 0; i < n; ++i) {
                    const cd pz = mz >= 0 ? ez[i * kmz + mz]
                                          : std::conj(ez[i * kmz - mz]);
                    ph[i] = pxy[i] * pz;
                    S += q[i] * ph[i];
                }
                energy += cfac * eak * std::norm(S);
                const double w = 2.0 * cfac * eak;
                for (int64_t i = 0; i < n; ++i) {
                    const cd c = S * std::conj(ph[i]);
                    const double gr = w * q[i] * c.imag();
                    forces[3 * i] -= gr * kx;
                    forces[3 * i + 1] -= gr * ky;
                    forces[3 * i + 2] -= gr * kz;
                    dedq[i] += w * c.real();
                }
            }
            lo_z = 1 - kmz;
        }
        lo_y = 1 - kmy;
    }
    return energy;
}

// dE/dq -> force chain rule (multdQdX semantics, calcChargeFlux.cu:291-313
// contract): each flux term's analytic dq/dx is contracted against the
// accumulated dedq and subtracted from the forces, so the native oracle's
// total force is the exact gradient of E(q(x)) like the engine's.
void cf_flux_chain_forces(const double* pos, int64_t n, const double* box,
                          int pbc, const double* dedq,
                          const int32_t* bond_idx, const double* bond_kb,
                          int64_t nb,
                          const int32_t* ang_idx, const double* ang_kt,
                          int64_t na,
                          const int32_t* wat_idx, const double* wat_p,
                          int64_t nw,
                          double* forces) {
    (void)n;
    for (int64_t b = 0; b < nb; ++b) {
        const int p1 = bond_idx[2 * b], p2 = bond_idx[2 * b + 1];
        double d[3];
        for (int k = 0; k < 3; ++k) d[k] = pos[3 * p2 + k] - pos[3 * p1 + k];
        if (pbc) min_image(d, box);
        const double r = std::sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
        // dq/dx rows are +-(k/r)d; column sums weighted by dedq collapse
        // to one scalar per bond
        const double g = (dedq[p1] - dedq[p2]) * bond_kb[2 * b] / r;
        for (int k = 0; k < 3; ++k) {
            forces[3 * p1 + k] += g * d[k];
            forces[3 * p2 + k] -= g * d[k];
        }
    }
    for (int64_t a = 0; a < na; ++a) {
        const int p1 = ang_idx[3 * a], p2 = ang_idx[3 * a + 1],
                  p3 = ang_idx[3 * a + 2];
        double d21[3], d23[3], d13[3];
        for (int k = 0; k < 3; ++k) {
            d21[k] = pos[3 * p1 + k] - pos[3 * p2 + k];
            d23[k] = pos[3 * p3 + k] - pos[3 * p2 + k];
            d13[k] = pos[3 * p3 + k] - pos[3 * p1 + k];
        }
        if (pbc) { min_image(d21, box); min_image(d23, box); min_image(d13, box); }
        const double r21 = std::sqrt(d21[0]*d21[0]+d21[1]*d21[1]+d21[2]*d21[2]);
        const double r23 = std::sqrt(d23[0]*d23[0]+d23[1]*d23[1]+d23[2]*d23[2]);
        const double r13_2 = d13[0]*d13[0]+d13[1]*d13[1]+d13[2]*d13[2];
        double cost = (r23 * r23 + r21 * r21 - r13_2) / (2.0 * r21 * r23);
        if (cost > 1.0) cost = 1.0;
        if (cost < -1.0) cost = -1.0;
        const double kk = ang_kt[2 * a];
        const double sin_inv = 1.0 / std::sqrt(1.0 - cost * cost);
        const double c1 = kk / (r21 * r23) * sin_inv;
        const double c21 = kk * cost * sin_inv / (r21 * r21);
        const double c23 = kk * cost * sin_inv / (r23 * r23);
        const double g = dedq[p1] - 2.0 * dedq[p2] + dedq[p3];
        for (int k = 0; k < 3; ++k) {
            const double v1 = -c1 * d23[k] + c21 * d21[k];
            const double v3 = -c1 * d21[k] + c23 * d23[k];
            forces[3 * p1 + k] -= g * v1;
            forces[3 * p2 + k] -= g * (-v1 - v3);
            forces[3 * p3 + k] -= g * v3;
        }
    }
    for (int64_t w = 0; w < nw; ++w) {
        const int pO = wat_idx[3 * w], pH1 = wat_idx[3 * w + 1],
                  pH2 = wat_idx[3 * w + 2];
        const double k1 = wat_p[5 * w], k2 = wat_p[5 * w + 1],
                     kub = wat_p[5 * w + 2];
        double d12[3], d13[3], d23[3];
        for (int k = 0; k < 3; ++k) {
            d12[k] = pos[3 * pH1 + k] - pos[3 * pO + k];
            d13[k] = pos[3 * pH2 + k] - pos[3 * pO + k];
            d23[k] = pos[3 * pH2 + k] - pos[3 * pH1 + k];
        }
        if (pbc) { min_image(d12, box); min_image(d13, box); min_image(d23, box); }
        const double r12 = std::sqrt(d12[0]*d12[0]+d12[1]*d12[1]+d12[2]*d12[2]);
        const double r13 = std::sqrt(d13[0]*d13[0]+d13[1]*d13[1]+d13[2]*d13[2]);
        const double r23 = std::sqrt(d23[0]*d23[0]+d23[1]*d23[1]+d23[2]*d23[2]);
        const double gO = dedq[pO], g1 = dedq[pH1], g2 = dedq[pH2];
        for (int k = 0; k < 3; ++k) {
            const double n12 = d12[k] / r12, n13 = d13[k] / r13,
                         ub = kub * d23[k] / r23;
            // column-wise contraction of the oracle's 3x3 water Jacobian
            forces[3 * pO + k] -= gO * (k1 + k2) * (n12 + n13)
                                  + g1 * (-k1 * n12 - k2 * n13)
                                  + g2 * (-k2 * n12 - k1 * n13);
            forces[3 * pH1 + k] -= gO * (-(k1 + k2) * n12 + 2.0 * ub)
                                   + g1 * (k1 * n12 - ub)
                                   + g2 * (k2 * n12 - ub);
            forces[3 * pH2 + k] -= gO * (-(k1 + k2) * n13 - 2.0 * ub)
                                   + g1 * (k2 * n13 + ub)
                                   + g2 * (k1 * n13 + ub);
        }
    }
}


// --- DCD trajectory IO ------------------------------------------------
//
// CHARMM/NAMD-format binary trajectory writer (the format OpenMM's
// DCDReporter emits and VMD / MDAnalysis ingest), so trajectories from
// this engine drop into the reference users' existing analysis stacks.
// Little-endian, Fortran record markers; unit-cell records as
// [A, gamma, B, beta, alpha, C] (angles in degrees — the NAMD/MDAnalysis
// convention).  Frame/step counts are rewritten on close.

struct CfDcd {
    FILE* f;
    int32_t natoms;
    int32_t nframes;
    int32_t nsavc;
    int32_t with_cell;
    std::vector<float> buf;
};

static void cf_wrec(FILE* f, const void* data, int32_t nbytes) {
    std::fwrite(&nbytes, 4, 1, f);
    std::fwrite(data, 1, (size_t)nbytes, f);
    std::fwrite(&nbytes, 4, 1, f);
}

void* cf_dcd_open(const char* path, int32_t natoms, double dt_ps,
                  int32_t nsavc, int32_t with_cell) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return nullptr;
    char hdr[84];
    std::memset(hdr, 0, sizeof hdr);
    std::memcpy(hdr, "CORD", 4);
    int32_t* ic = reinterpret_cast<int32_t*>(hdr + 4);
    ic[0] = 0;              // nframes (rewritten on close)
    ic[1] = nsavc;          // step of first frame
    ic[2] = nsavc;          // steps between frames
    ic[3] = 0;              // total steps (rewritten on close)
    float delta = (float)(dt_ps / 0.04888821);  // ps -> AKMA time units
    std::memcpy(&ic[9], &delta, 4);
    ic[10] = with_cell ? 1 : 0;
    ic[19] = 24;            // CHARMM version: unit-cell records honored
    cf_wrec(f, hdr, 84);
    char title[84];
    std::memset(title, 0, sizeof title);
    int32_t ntitle = 1;
    std::memcpy(title, &ntitle, 4);
    std::memcpy(title + 4, "Created by chargeflux_tpu", 25);
    std::memset(title + 29, ' ', 84 - 29);
    cf_wrec(f, title, 84);
    cf_wrec(f, &natoms, 4);
    CfDcd* h = new CfDcd{f, natoms, 0, nsavc, with_cell, {}};
    h->buf.resize((size_t)natoms);
    return h;
}

// xyz: double[natoms*3] in Angstrom (caller converts nm -> A);
// cell: double[6] = [A, gamma, B, beta, alpha, C] or null when cell-less.
int cf_dcd_write_frame(void* handle, const double* xyz, const double* cell) {
    CfDcd* h = static_cast<CfDcd*>(handle);
    if (!h || !h->f) return -1;
    if (h->with_cell) {
        if (!cell) return -2;
        cf_wrec(h->f, cell, 48);
    }
    for (int axis = 0; axis < 3; ++axis) {
        for (int64_t i = 0; i < h->natoms; ++i)
            h->buf[(size_t)i] = (float)xyz[3 * i + axis];
        cf_wrec(h->f, h->buf.data(), 4 * h->natoms);
    }
    h->nframes += 1;
    return 0;
}

int cf_dcd_close(void* handle) {
    CfDcd* h = static_cast<CfDcd*>(handle);
    if (!h) return -1;
    int rc = 0;
    if (h->f) {
        // record marker (4) + "CORD" (4) -> icntrl[0] at byte 8,
        // icntrl[3] (total steps) at byte 8 + 3*4 = 20
        int32_t steps = h->nframes * h->nsavc;
        if (std::fseek(h->f, 8, SEEK_SET) == 0)
            std::fwrite(&h->nframes, 4, 1, h->f);
        if (std::fseek(h->f, 20, SEEK_SET) == 0)
            std::fwrite(&steps, 4, 1, h->f);
        rc = std::fclose(h->f);
    }
    delete h;
    return rc;
}


}  // extern "C"
