// graphcore: native host-side runtime of qamreconciliation_tpu_torch, a copy
// of qamreconciliation_tpu/native/graphcore.cpp (the port imports nothing of
// the JAX package).
//
// Two roles:
//  1. Fast edge-list CSV parsing for DVB-S2-scale LDPC codes (the shared
//     `eid,cid,vid` format, see qamreconciliation_tpu_torch/utils/edgefile.py).
//  2. A single-core scalar flooding sum-product syndrome decoder with the
//     same algorithm and convergence semantics as the reference's compiled
//     decoder (reference: qamreconciliation/decoder.pyx:391-455): the
//     float64 oracle the port's decoders are held to, and the CPU baseline
//     a benchmark divides by.
//
// Fresh C++17 implementation; exposed through a plain C ABI for ctypes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

// Exact pairwise box-plus: sgn(a)sgn(b)min(|a|,|b|) + log1p(e^-|a+b|) - log1p(e^-|a-b|)
inline double box_plus(double a, double b) {
    double s = ((a < 0) != (b < 0)) ? -1.0 : 1.0;
    double m = std::fmin(std::fabs(a), std::fabs(b));
    return s * m + std::log1p(std::exp(-std::fabs(a + b)))
                 - std::log1p(std::exp(-std::fabs(a - b)));
}

struct Graph {
    int64_t V = 0, C = 0, E = 0;
    // CSR adjacency: edges grouped by node, in increasing edge-id order.
    std::vector<int64_t> c_ptr, c_edge;   // per check node
    std::vector<int64_t> v_ptr, v_edge;   // per variable node
    std::vector<int64_t> evid, ecid;      // edge -> node ids
};

struct DecoderImpl {
    Graph g;
    int64_t dc_max = 0;
    // scratch (persist across decode calls: no per-call allocation)
    std::vector<double> v2c, c2v, total, fwd, bwd;
    std::vector<uint8_t> synd_hat;
};

void build_csr(const int64_t* ids, int64_t E, int64_t n,
               std::vector<int64_t>& ptr, std::vector<int64_t>& edge) {
    ptr.assign(static_cast<size_t>(n) + 1, 0);
    for (int64_t e = 0; e < E; ++e) ptr[static_cast<size_t>(ids[e]) + 1]++;
    for (int64_t i = 0; i < n; ++i) ptr[static_cast<size_t>(i) + 1] += ptr[static_cast<size_t>(i)];
    edge.resize(static_cast<size_t>(E));
    std::vector<int64_t> cur(ptr.begin(), ptr.end() - 1);
    for (int64_t e = 0; e < E; ++e)
        edge[static_cast<size_t>(cur[static_cast<size_t>(ids[e])]++)] = e;
}

// Hard-decision syndrome test on an LLR vector: bit = 1 iff llr < 0.
bool llr_consistent(const DecoderImpl& d, const double* llr, const uint8_t* synd) {
    const Graph& g = d.g;
    for (int64_t c = 0; c < g.C; ++c) {
        int parity = synd[c] & 1;
        for (int64_t k = g.c_ptr[static_cast<size_t>(c)]; k < g.c_ptr[static_cast<size_t>(c) + 1]; ++k) {
            int64_t e = g.c_edge[static_cast<size_t>(k)];
            parity ^= (llr[g.evid[static_cast<size_t>(e)]] < 0.0) ? 1 : 0;
        }
        if (parity) return false;
    }
    return true;
}

}  // namespace

extern "C" {

// ------------------------------------------------------------------ CSV IO

// Parse an `eid,cid,vid` CSV (header line skipped).  Returns the number of
// data rows (including the first totals row, if present — the caller applies
// the first-row convention), or -1 on error.  Arrays are malloc'd; free with
// gc_free_i64.
int64_t gc_load_edge_csv(const char* path, int64_t** out_eid,
                         int64_t** out_cid, int64_t** out_vid) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    std::fseek(f, 0, SEEK_END);
    long fsize = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::vector<char> buf(static_cast<size_t>(fsize) + 1);
    size_t rd = std::fread(buf.data(), 1, static_cast<size_t>(fsize), f);
    std::fclose(f);
    buf[rd] = '\0';

    std::vector<int64_t> eid, cid, vid;
    eid.reserve(1 << 16); cid.reserve(1 << 16); vid.reserve(1 << 16);

    const char* p = buf.data();
    const char* end = buf.data() + rd;
    // skip header line
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;

    auto parse_int = [&](int64_t& out) -> bool {
        while (p < end && (*p == ' ' || *p == '\t')) ++p;
        bool neg = false;
        if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
        if (p >= end || *p < '0' || *p > '9') return false;
        int64_t v = 0;
        while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
        out = neg ? -v : v;
        return true;
    };

    while (p < end) {
        // skip blank lines
        if (*p == '\n' || *p == '\r') { ++p; continue; }
        int64_t a, b, c;
        if (!parse_int(a)) break;
        if (p < end && *p == ',') ++p; else break;
        if (!parse_int(b)) break;
        if (p < end && *p == ',') ++p; else break;
        if (!parse_int(c)) break;
        eid.push_back(a); cid.push_back(b); vid.push_back(c);
        while (p < end && *p != '\n') ++p;
        if (p < end) ++p;
    }

    int64_t n = static_cast<int64_t>(eid.size());
    *out_eid = static_cast<int64_t*>(std::malloc(sizeof(int64_t) * static_cast<size_t>(n)));
    *out_cid = static_cast<int64_t*>(std::malloc(sizeof(int64_t) * static_cast<size_t>(n)));
    *out_vid = static_cast<int64_t*>(std::malloc(sizeof(int64_t) * static_cast<size_t>(n)));
    if (!*out_eid || !*out_cid || !*out_vid) return -1;
    std::memcpy(*out_eid, eid.data(), sizeof(int64_t) * static_cast<size_t>(n));
    std::memcpy(*out_cid, cid.data(), sizeof(int64_t) * static_cast<size_t>(n));
    std::memcpy(*out_vid, vid.data(), sizeof(int64_t) * static_cast<size_t>(n));
    return n;
}

void gc_free_i64(int64_t* p) { std::free(p); }

// ------------------------------------------------------------------ decoder

void* gc_decoder_new(const int64_t* vid, const int64_t* cid, int64_t E) {
    auto* d = new DecoderImpl();
    Graph& g = d->g;
    g.E = E;
    g.evid.assign(vid, vid + E);
    g.ecid.assign(cid, cid + E);
    int64_t V = 0, C = 0;
    for (int64_t e = 0; e < E; ++e) {
        if (vid[e] + 1 > V) V = vid[e] + 1;
        if (cid[e] + 1 > C) C = cid[e] + 1;
    }
    g.V = V; g.C = C;
    build_csr(cid, E, C, g.c_ptr, g.c_edge);
    build_csr(vid, E, V, g.v_ptr, g.v_edge);
    for (int64_t c = 0; c < C; ++c) {
        int64_t deg = g.c_ptr[static_cast<size_t>(c) + 1] - g.c_ptr[static_cast<size_t>(c)];
        if (deg > d->dc_max) d->dc_max = deg;
    }
    d->v2c.resize(static_cast<size_t>(E));
    d->c2v.resize(static_cast<size_t>(E));
    d->total.resize(static_cast<size_t>(V));
    d->fwd.resize(static_cast<size_t>(d->dc_max));
    d->bwd.resize(static_cast<size_t>(d->dc_max));
    d->synd_hat.resize(static_cast<size_t>(C));
    return d;
}

void gc_decoder_free(void* h) { delete static_cast<DecoderImpl*>(h); }

int64_t gc_decoder_vnum(void* h) { return static_cast<DecoderImpl*>(h)->g.V; }
int64_t gc_decoder_cnum(void* h) { return static_cast<DecoderImpl*>(h)->g.C; }
int64_t gc_decoder_ednum(void* h) { return static_cast<DecoderImpl*>(h)->g.E; }

// Syndrome of a hard word: synd[c] = XOR of word over the check's neighborhood.
void gc_eval_syndrome(void* h, const uint8_t* word, uint8_t* synd) {
    const Graph& g = static_cast<DecoderImpl*>(h)->g;
    std::memset(synd, 0, static_cast<size_t>(g.C));
    for (int64_t e = 0; e < g.E; ++e)
        synd[g.ecid[static_cast<size_t>(e)]] ^= (word[g.evid[static_cast<size_t>(e)]] & 1);
}

// Flooding sum-product syndrome decode.  Convergence semantics match the
// reference (reference: qamreconciliation/decoder.pyx:391-436): returns
// iters = 0 with success for an already-consistent input (LLRs passed
// through), iters = max_iter without success on failure; final_llr always
// written.  Returns the iteration count; *success set to 0/1.
int gc_decoder_decode(void* h, const double* lappr, const uint8_t* synd,
                      int max_iter, double* final_llr, int* success) {
    DecoderImpl& d = *static_cast<DecoderImpl*>(h);
    const Graph& g = d.g;

    if (llr_consistent(d, lappr, synd)) {
        std::memcpy(final_llr, lappr, sizeof(double) * static_cast<size_t>(g.V));
        *success = 1;
        return 0;
    }

    // seed totals with the priors so a max_iter <= 0 call returns the
    // input LLRs rather than stale scratch from a previous decode
    std::memcpy(d.total.data(), lappr, sizeof(double) * static_cast<size_t>(g.V));

    // half-iteration: seed v2c with priors, c2v with zeros
    for (int64_t v = 0; v < g.V; ++v)
        for (int64_t k = g.v_ptr[static_cast<size_t>(v)]; k < g.v_ptr[static_cast<size_t>(v) + 1]; ++k)
            d.v2c[static_cast<size_t>(g.v_edge[static_cast<size_t>(k)])] = lappr[v];

    for (int it = 1; it <= max_iter; ++it) {
        // check-node update: extrinsic box-plus via forward/backward scans
        for (int64_t c = 0; c < g.C; ++c) {
            int64_t lo = g.c_ptr[static_cast<size_t>(c)];
            int64_t deg = g.c_ptr[static_cast<size_t>(c) + 1] - lo;
            double pref = synd[c] ? -1.0 : 1.0;
            if (deg == 1) {
                // box-plus over the empty set: certainty of even parity
                d.c2v[static_cast<size_t>(g.c_edge[static_cast<size_t>(lo)])] = pref * 1e30;
                continue;
            }
            const int64_t* ce = g.c_edge.data() + lo;
            d.fwd[0] = d.v2c[static_cast<size_t>(ce[0])];
            for (int64_t i = 1; i < deg; ++i)
                d.fwd[static_cast<size_t>(i)] =
                    box_plus(d.fwd[static_cast<size_t>(i - 1)], d.v2c[static_cast<size_t>(ce[i])]);
            d.bwd[static_cast<size_t>(deg - 1)] = d.v2c[static_cast<size_t>(ce[deg - 1])];
            for (int64_t i = deg - 2; i >= 0; --i)
                d.bwd[static_cast<size_t>(i)] =
                    box_plus(d.bwd[static_cast<size_t>(i + 1)], d.v2c[static_cast<size_t>(ce[i])]);
            d.c2v[static_cast<size_t>(ce[0])] = pref * d.bwd[1];
            for (int64_t i = 1; i < deg - 1; ++i)
                d.c2v[static_cast<size_t>(ce[i])] =
                    pref * box_plus(d.fwd[static_cast<size_t>(i - 1)], d.bwd[static_cast<size_t>(i + 1)]);
            d.c2v[static_cast<size_t>(ce[deg - 1])] = pref * d.fwd[static_cast<size_t>(deg - 2)];
        }

        // variable-node update: total = prior + sum(c2v); v2c = total - c2v
        for (int64_t v = 0; v < g.V; ++v) {
            double t = lappr[v];
            for (int64_t k = g.v_ptr[static_cast<size_t>(v)]; k < g.v_ptr[static_cast<size_t>(v) + 1]; ++k)
                t += d.c2v[static_cast<size_t>(g.v_edge[static_cast<size_t>(k)])];
            d.total[static_cast<size_t>(v)] = t;
            for (int64_t k = g.v_ptr[static_cast<size_t>(v)]; k < g.v_ptr[static_cast<size_t>(v) + 1]; ++k) {
                int64_t e = g.v_edge[static_cast<size_t>(k)];
                d.v2c[static_cast<size_t>(e)] = t - d.c2v[static_cast<size_t>(e)];
            }
        }

        if (llr_consistent(d, d.total.data(), synd)) {
            std::memcpy(final_llr, d.total.data(), sizeof(double) * static_cast<size_t>(g.V));
            *success = 1;
            return it;
        }
    }

    std::memcpy(final_llr, d.total.data(), sizeof(double) * static_cast<size_t>(g.V));
    *success = 0;
    return max_iter;
}

}  // extern "C"
