// Batched Levenshtein distance -- the eval harness's native host-side
// library (the port's copy of ishara_tpu/native/levenshtein.cpp: the
// reference leans on the python-Levenshtein C extension; this is the
// framework's own, batch-oriented and OpenMP-free for portability). Built on
// demand by ishara_tpu_torch.native with g++ -O3. Not a device kernel: it
// runs on the host beside the card.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// a: [batch, na_max] int32 code points, b: [batch, nb_max]
// la/lb: per-row lengths; out: [batch] distances.
void batch_levenshtein(const int32_t* a, const int32_t* b,
                       const int32_t* la, const int32_t* lb,
                       int32_t batch, int32_t na_max, int32_t nb_max,
                       int32_t* out) {
    std::vector<int32_t> row(static_cast<size_t>(nb_max) + 1);
    for (int32_t s = 0; s < batch; ++s) {
        const int32_t* as = a + static_cast<size_t>(s) * na_max;
        const int32_t* bs = b + static_cast<size_t>(s) * nb_max;
        const int32_t n = la[s], m = lb[s];
        if (n == 0) { out[s] = m; continue; }
        if (m == 0) { out[s] = n; continue; }
        for (int32_t j = 0; j <= m; ++j) row[j] = j;
        for (int32_t i = 1; i <= n; ++i) {
            int32_t diag = row[0];
            row[0] = i;
            const int32_t ai = as[i - 1];
            for (int32_t j = 1; j <= m; ++j) {
                const int32_t up = row[j];
                const int32_t cost = diag + (ai != bs[j - 1]);
                row[j] = std::min({up + 1, row[j - 1] + 1, cost});
                diag = up;
            }
        }
        out[s] = row[m];
    }
}

}  // extern "C"
