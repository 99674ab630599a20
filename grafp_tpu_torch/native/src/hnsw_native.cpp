// HNSW (Malkov & Yashunin 2016) for the host side of the port's retrieval
// stack: the port's own copy of grafp_tpu/native/src/hnsw_native.cpp, with
// the same algorithm and arithmetic, so that both packages build the same
// graph from the same rows and seed. The reference's 'hnsw' eval mode is
// CPU FAISS IndexHNSWFlat(M=16, efConstruction=80) (reference
// eval.py:90-98); HNSW is a sequential graph walk, so it runs on the host.
//
// Algorithm (the semantics of the Python backend in retrieval/hnsw.py):
// geometric level sampling (mult = 1/ln(M)), greedy descent through the
// upper layers, ef-bounded beam at each insertion layer, closest-M
// neighbor selection with closest-cap backlink pruning. Distances are
// squared L2. Levels come from std::mt19937(seed), so the graph differs
// from the Python backend's (numpy RandomState(seed)).
//
// Built by grafp_tpu_torch/native/hnsw_native.py with
//   g++ -O3 -std=c++17 -shared -fPIC hnsw_native.cpp -o libhnsw_native-<hash>.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <random>
#include <utility>
#include <vector>

namespace {

struct HNSW {
    int d, m, m0, efc;
    double mult;
    std::mt19937 rng;
    std::vector<float> vecs;                 // n * d
    std::vector<int> levels;                 // per node
    // nbrs[level][node] -> neighbor ids
    std::vector<std::vector<std::vector<uint32_t>>> nbrs;
    long n = 0;
    int entry = -1;
    int max_level = -1;
    // epoch-stamped visited marks (no per-query clearing)
    std::vector<uint32_t> mark;
    uint32_t epoch = 0;

    HNSW(int d_, int m_, int efc_, unsigned seed)
        : d(d_), m(m_), m0(2 * m_), efc(efc_),
          mult(1.0 / std::log(static_cast<double>(m_))), rng(seed) {}

    inline float dist(const float* q, uint32_t id) const {
        const float* v = vecs.data() + static_cast<size_t>(id) * d;
        float acc = 0.f;
        for (int j = 0; j < d; ++j) {
            const float t = v[j] - q[j];
            acc += t * t;
        }
        return acc;
    }

    inline void begin_visit() {
        if (++epoch == 0) {                   // wrapped: reset stamps
            std::fill(mark.begin(), mark.end(), 0u);
            epoch = 1;
        }
        if (mark.size() < static_cast<size_t>(n)) mark.resize(n, 0u);
    }
    inline bool visited(uint32_t id) { return mark[id] == epoch; }
    inline void visit(uint32_t id) { mark[id] = epoch; }

    // ef-bounded beam at `level`; returns (dist, id) ascending by dist.
    std::vector<std::pair<float, uint32_t>>
    search_layer(const float* q, uint32_t ep, int ef, int level) {
        using DI = std::pair<float, uint32_t>;
        begin_visit();
        std::priority_queue<DI, std::vector<DI>, std::greater<DI>> cand;
        std::priority_queue<DI> best;         // max-heap: worst on top
        const float d0 = dist(q, ep);
        visit(ep);
        cand.emplace(d0, ep);
        best.emplace(d0, ep);
        const auto& layer = nbrs[level];
        while (!cand.empty()) {
            const auto [dc, c] = cand.top();
            if (dc > best.top().first && best.size() >= static_cast<size_t>(ef))
                break;
            cand.pop();
            for (uint32_t nb : layer[c]) {
                if (visited(nb)) continue;
                visit(nb);
                const float dn = dist(q, nb);
                if (best.size() < static_cast<size_t>(ef) ||
                    dn < best.top().first) {
                    cand.emplace(dn, nb);
                    best.emplace(dn, nb);
                    if (best.size() > static_cast<size_t>(ef)) best.pop();
                }
            }
        }
        std::vector<DI> out(best.size());
        for (size_t i = out.size(); i-- > 0;) {
            out[i] = best.top();
            best.pop();
        }
        return out;
    }

    uint32_t greedy(const float* q, uint32_t cur, int level) {
        float cur_d = dist(q, cur);
        bool improved = true;
        while (improved) {
            improved = false;
            for (uint32_t nb : nbrs[level][cur]) {
                const float dn = dist(q, nb);
                if (dn < cur_d) {
                    cur = nb;
                    cur_d = dn;
                    improved = true;
                }
            }
        }
        return cur;
    }

    void insert(uint32_t idx) {
        std::uniform_real_distribution<double> uni(1e-12, 1.0);
        const int level =
            static_cast<int>(-std::log(uni(rng)) * mult);
        levels.push_back(level);
        const int prev_max = max_level;
        while (max_level < level) {
            ++max_level;
            nbrs.emplace_back(idx);           // empty lists for 0..idx-1
        }
        for (auto& layer : nbrs)
            if (layer.size() <= idx) layer.resize(idx + 1);
        if (entry < 0) {
            entry = static_cast<int>(idx);
            return;
        }
        const float* q = vecs.data() + static_cast<size_t>(idx) * d;
        uint32_t cur = static_cast<uint32_t>(entry);
        for (int l = prev_max; l > level; --l) cur = greedy(q, cur, l);
        for (int l = std::min(level, prev_max); l >= 0; --l) {
            auto found = search_layer(q, cur, efc, l);
            const size_t cap = (l == 0) ? m0 : m;
            auto& mine = nbrs[l][idx];
            mine.clear();
            for (size_t i = 0; i < found.size() && i < cap; ++i)
                mine.push_back(found[i].second);
            for (uint32_t nb : mine) {
                auto& lst = nbrs[l][nb];
                lst.push_back(idx);
                if (lst.size() > cap) {       // keep the cap closest
                    const float* vn =
                        vecs.data() + static_cast<size_t>(nb) * d;
                    std::vector<std::pair<float, uint32_t>> scored;
                    scored.reserve(lst.size());
                    for (uint32_t x : lst) scored.emplace_back(dist(vn, x), x);
                    std::partial_sort(scored.begin(), scored.begin() + cap,
                                      scored.end());
                    lst.resize(cap);
                    for (size_t i = 0; i < cap; ++i) lst[i] = scored[i].second;
                }
            }
            cur = found.front().second;
        }
        if (level > prev_max) entry = static_cast<int>(idx);
    }
};

}  // namespace

extern "C" {

void* hnsw_create(int d, int m, int ef_construction, unsigned seed) {
    if (d <= 0 || m < 2 || ef_construction < 1) return nullptr;
    return new HNSW(d, m, ef_construction, seed);
}

void hnsw_destroy(void* h) { delete static_cast<HNSW*>(h); }

long hnsw_ntotal(void* h) { return static_cast<HNSW*>(h)->n; }

// Append n rows (row-major n x d float32) and insert them sequentially.
int hnsw_add(void* h, const float* data, long n) {
    if (!h || n < 0) return -1;
    HNSW* s = static_cast<HNSW*>(h);
    const long start = s->n;
    s->vecs.insert(s->vecs.end(), data,
                   data + static_cast<size_t>(n) * s->d);
    s->n += n;
    for (long i = 0; i < n; ++i)
        s->insert(static_cast<uint32_t>(start + i));
    return 0;
}

// nq x d queries -> (nq x k) squared-L2 distances + ids (-1 padded).
int hnsw_search(void* h, const float* q, long nq, int k, int ef_search,
                float* out_d, long* out_i) {
    if (!h || k < 1) return -1;
    HNSW* s = static_cast<HNSW*>(h);
    const int ef = std::max(ef_search, k);
    for (long r = 0; r < nq; ++r) {
        float* od = out_d + r * k;
        long* oi = out_i + r * k;
        for (int j = 0; j < k; ++j) {
            od[j] = std::numeric_limits<float>::infinity();
            oi[j] = -1;
        }
        if (s->entry < 0) continue;
        const float* qr = q + static_cast<size_t>(r) * s->d;
        uint32_t cur = static_cast<uint32_t>(s->entry);
        for (int l = s->max_level; l > 0; --l) cur = s->greedy(qr, cur, l);
        auto found = s->search_layer(qr, cur, ef, 0);
        const int kk = std::min<long>(k, found.size());
        for (int j = 0; j < kk; ++j) {
            od[j] = found[j].first;
            oi[j] = found[j].second;
        }
    }
    return 0;
}

// Copy rows [start, start+n) into out (n x d).
int hnsw_reconstruct(void* h, long start, long n, float* out) {
    HNSW* s = static_cast<HNSW*>(h);
    if (!s || start < 0 || start + n > s->n) return -1;
    std::memcpy(out, s->vecs.data() + static_cast<size_t>(start) * s->d,
                static_cast<size_t>(n) * s->d * sizeof(float));
    return 0;
}

}  // extern "C"
