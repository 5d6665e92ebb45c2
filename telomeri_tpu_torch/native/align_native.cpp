// Native helpers for the validator's alignment core (utils/align.py).
// Loaded via ctypes (align_native.py); everything degrades to numpy/python
// when the library is absent. Parity tested in tests/test_native.py.
//
// tel_radix_argsort_kmers: LSD radix sort of packed k-mers (int64 keys, all
//   non-negative, significant bits = 2k <= 62) emitting int32 positions in
//   sorted-key order plus the sorted keys. Replaces np.argsort + two fancy
//   gathers — the dominant serial cost of KmerIndex.build at genome scale
//   (comparison sort on 300M keys). Order among equal keys is the stable
//   original order (stronger than the unstable np.argsort it replaces;
//   lookup_unique only reads positions of unique keys, so any order is valid).
//
// tel_lis_chain: longest strictly-increasing subsequence (patience sorting),
//   byte-identical index output to utils/align.py lis_chain (ties resolved to
//   the earliest candidates).

#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

extern "C" {

// Sorts by the low `bits` bits of each key (callers pass 2*k). pos_out gets
// the argsort permutation; keys_out the keys in sorted order.
void tel_radix_argsort_kmers(const int64_t* keys, int64_t n, int bits,
                             int32_t* pos_out, int64_t* keys_out) {
    std::vector<int64_t> kbuf(n);
    std::vector<int32_t> pbuf(n);
    int64_t* ka = kbuf.data();
    int32_t* pa = pbuf.data();
    int64_t* kb = keys_out;
    int32_t* pb = pos_out;
    int passes = (bits + 7) / 8;

    // pass 0 reads the const input, generating identity positions on the fly
    {
        int64_t count[256] = {0};
        for (int64_t i = 0; i < n; i++) count[keys[i] & 0xFF]++;
        int64_t sum = 0, offs[256];
        for (int b = 0; b < 256; b++) { offs[b] = sum; sum += count[b]; }
        for (int64_t i = 0; i < n; i++) {
            int64_t o = offs[keys[i] & 0xFF]++;
            ka[o] = keys[i];
            pa[o] = (int32_t)i;
        }
    }
    // passes 1..P-1 ping-pong (ka,pa) <-> (kb,pb)
    for (int p = 1; p < passes; p++) {
        int shift = p * 8;
        int64_t count[256] = {0};
        for (int64_t i = 0; i < n; i++) count[(ka[i] >> shift) & 0xFF]++;
        int64_t sum = 0, offs[256];
        for (int b = 0; b < 256; b++) { offs[b] = sum; sum += count[b]; }
        for (int64_t i = 0; i < n; i++) {
            int64_t o = offs[(ka[i] >> shift) & 0xFF]++;
            kb[o] = ka[i];
            pb[o] = pa[i];
        }
        std::swap(ka, kb);
        std::swap(pa, pb);
    }
    // results live in (ka, pa)
    if (ka != keys_out)
        std::memcpy(keys_out, ka, (size_t)n * sizeof(int64_t));
    if (pa != pos_out)
        std::memcpy(pos_out, pa, (size_t)n * sizeof(int32_t));
}

// Patience-sorting LIS over int64 values; returns chain length, indices in
// out (ascending). Exact port of utils/align.py lis_chain.
int64_t tel_lis_chain(const int64_t* values, int64_t n, int64_t* out) {
    if (n == 0) return 0;
    std::vector<int64_t> tails;       // smallest tail value per run length
    std::vector<int64_t> tails_idx;
    std::vector<int64_t> parent(n, -1);
    tails.reserve(1024); tails_idx.reserve(1024);
    for (int64_t i = 0; i < n; i++) {
        int64_t v = values[i];
        // bisect_left
        size_t lo = 0, hi = tails.size();
        while (lo < hi) {
            size_t mid = (lo + hi) / 2;
            if (tails[mid] < v) lo = mid + 1; else hi = mid;
        }
        if (lo == tails.size()) { tails.push_back(v); tails_idx.push_back(i); }
        else { tails[lo] = v; tails_idx[lo] = i; }
        if (lo > 0) parent[i] = tails_idx[lo - 1];
    }
    int64_t len = 0;
    for (int64_t i = tails_idx.back(); i >= 0; i = parent[i]) len++;
    int64_t w = len;
    for (int64_t i = tails_idx.back(); i >= 0; i = parent[i]) out[--w] = i;
    return len;
}

// Myers bit-vector edit distance over uint64 word blocks — exact port of the
// python-bigint myers_pair in utils/align.py (same op order, same boundary
// handling). mode: 0 = global, 1 = free_t_start, 2 = free_t_end.
// Callers handle the m==0 / tn==0 early-outs; q/t are ACGT bytes (other bytes
// code like utils/align._CODE_LUT: clip(searchsorted) semantics).
int64_t tel_myers_pair(const uint8_t* q, int64_t m,
                       const uint8_t* t, int64_t tn, int mode) {
    static int8_t lut[256];
    static bool lut_init = false;
    if (!lut_init) {
        const uint8_t bases[4] = {'A', 'C', 'G', 'T'};
        for (int b = 0; b < 256; b++) {
            int lo = 0;                    // searchsorted(left) then clip 0..3
            while (lo < 4 && bases[lo] < (uint8_t)b) lo++;
            lut[b] = (int8_t)(lo > 3 ? 3 : lo);
        }
        lut_init = true;
    }
    int64_t nw = (m + 63) / 64;
    std::vector<uint64_t> peq(4 * nw, 0), pv(nw), mv(nw, 0),
        xv(nw), xh(nw), ph(nw), mh(nw);
    for (int64_t i = 0; i < m; i++)
        peq[(size_t)lut[q[i]] * nw + i / 64] |= 1ULL << (i % 64);
    uint64_t last_mask = (m % 64) ? ((1ULL << (m % 64)) - 1) : ~0ULL;
    for (int64_t w = 0; w < nw; w++) pv[w] = ~0ULL;
    pv[nw - 1] = last_mask;
    int64_t top_w = (m - 1) / 64;
    int top_b = (int)((m - 1) % 64);
    int64_t score = m, best = m;
    uint64_t hin = (mode == 1) ? 0ULL : 1ULL;
    for (int64_t j = 0; j < tn; j++) {
        const uint64_t* eq = &peq[(size_t)lut[t[j]] * nw];
        // xv = eq | mv ; xh = (((eq & pv) + pv) ^ pv) | eq  (multi-word add)
        uint64_t carry = 0;
        for (int64_t w = 0; w < nw; w++) {
            xv[w] = eq[w] | mv[w];
            uint64_t a = eq[w] & pv[w];
            uint64_t s = a + pv[w];
            uint64_t c1 = s < a;
            uint64_t s2 = s + carry;
            carry = c1 | (s2 < s);
            xh[w] = (s2 ^ pv[w]) | eq[w];
        }
        for (int64_t w = 0; w < nw; w++) {
            ph[w] = mv[w] | ~(xh[w] | pv[w]);
            mh[w] = pv[w] & xh[w];
        }
        ph[nw - 1] &= last_mask;
        mh[nw - 1] &= last_mask;
        score += (int64_t)((ph[top_w] >> top_b) & 1);
        score -= (int64_t)((mh[top_w] >> top_b) & 1);
        // ph = (ph << 1) | hin ; mh <<= 1  (multi-word shifts)
        uint64_t cin = hin;
        for (int64_t w = 0; w < nw; w++) {
            uint64_t out = ph[w] >> 63;
            ph[w] = (ph[w] << 1) | cin;
            cin = out;
        }
        cin = 0;
        for (int64_t w = 0; w < nw; w++) {
            uint64_t out = mh[w] >> 63;
            mh[w] = (mh[w] << 1) | cin;
            cin = out;
        }
        for (int64_t w = 0; w < nw; w++) {
            pv[w] = mh[w] | ~(xv[w] | ph[w]);
            mv[w] = ph[w] & xv[w];
        }
        pv[nw - 1] &= last_mask;
        mv[nw - 1] &= last_mask;
        if (mode == 2 && score < best) best = score;
    }
    return mode == 2 ? best : score;
}

// tel_gap_trace: unit-cost global alignment of target gap t (n) vs read gap
// q (m) WITH traceback — the polish stage's inter-anchor aligner
// (scaffold/polish.py _dp_trace). Emits ops in forward order: kind 0 = M
// (q base aligned to t position), 1 = D (t position deleted in the read),
// 2 = I (q base inserted before t position). Tie-break matches the python
// mirror exactly: diagonal > up > left. Returns the op count (= path length
// <= n + m). Caller sizes the out arrays to n + m.
int64_t tel_gap_trace(const uint8_t* t, int64_t n, const uint8_t* q, int64_t m,
                      int32_t* kind_out, int32_t* tpos_out, int32_t* qpos_out) {
    const int64_t w = m + 1;
    std::vector<int32_t> D((n + 1) * w);
    for (int64_t j = 0; j <= m; j++) D[j] = (int32_t)j;
    for (int64_t i = 1; i <= n; i++) {
        const int32_t* prev = &D[(i - 1) * w];
        int32_t* cur = &D[i * w];
        cur[0] = (int32_t)i;
        const uint8_t tc = t[i - 1];
        for (int64_t j = 1; j <= m; j++) {
            int32_t best = prev[j - 1] + (q[j - 1] != tc);
            int32_t up = prev[j] + 1;
            if (up < best) best = up;
            int32_t left = cur[j - 1] + 1;
            if (left < best) best = left;
            cur[j] = best;
        }
    }
    int64_t i = n, j = m, k = 0;
    // build reversed, then flip in place
    while (i > 0 || j > 0) {
        const int32_t d = D[i * w + j];
        if (i > 0 && j > 0 &&
            d == D[(i - 1) * w + (j - 1)] + (t[i - 1] != q[j - 1])) {
            kind_out[k] = 0; tpos_out[k] = (int32_t)(i - 1);
            qpos_out[k] = (int32_t)(j - 1); i--; j--;
        } else if (i > 0 && d == D[(i - 1) * w + j] + 1) {
            kind_out[k] = 1; tpos_out[k] = (int32_t)(i - 1);
            qpos_out[k] = (int32_t)j; i--;
        } else {
            kind_out[k] = 2; tpos_out[k] = (int32_t)i;
            qpos_out[k] = (int32_t)(j - 1); j--;
        }
        k++;
    }
    for (int64_t a = 0, b = k - 1; a < b; a++, b--) {
        std::swap(kind_out[a], kind_out[b]);
        std::swap(tpos_out[a], tpos_out[b]);
        std::swap(qpos_out[a], qpos_out[b]);
    }
    return k;
}

}  // extern "C"
