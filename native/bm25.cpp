// Native BM25 scoring core.
//
// Sparse retrieval is offline/host-side in this
// framework (hard-negative mining only), so the Lucene/pyserini dependency
// of the reference (bm25/bm25_topiocqa.py:17,152-154) is replaced by this
// self-contained C++ engine: a CSR inverted index plus a multithreaded
// term-at-a-time scorer with Lucene-compatible BM25 weighting
//   idf(t)  = ln(1 + (N - df + 0.5) / (df + 0.5))
//   s(t, d) = idf * tf / (tf + k1 * (1 - b + b * dl/avgdl))   // * (k1+1) in
// classic BM25; Lucene drops the (k1+1) factor, which rescales all scores
// uniformly and preserves ranking. We keep (k1+1) configurable host-side by
// folding it into idf if exact classic scores are wanted.
//
// Python owns analysis/vocab (mine/analysis.py); this library owns the
// scoring hot loop. Exposed via a C ABI for ctypes.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Index {
  int64_t n_docs = 0;
  double avgdl = 0.0;
  const int32_t* doc_lens = nullptr;     // [n_docs]
  const int64_t* term_offsets = nullptr; // [n_terms + 1] CSR offsets
  const int32_t* post_docs = nullptr;    // postings doc ids
  const int32_t* post_freqs = nullptr;   // postings term freqs
  int64_t n_terms = 0;
  std::vector<int32_t> doc_lens_copy;
  std::vector<int64_t> term_offsets_copy;
  std::vector<int32_t> post_docs_copy;
  std::vector<int32_t> post_freqs_copy;
};

struct Hit {
  float score;
  int32_t doc;
};

inline bool hit_less(const Hit& a, const Hit& b) {
  // max-first ordering; ties broken by lower doc id first (Lucene-like)
  if (a.score != b.score) return a.score > b.score;
  return a.doc < b.doc;
}

void score_one_query(const Index& idx, const int32_t* terms, int64_t n_terms,
                     const float* idfs, double k1, double b, int top_k,
                     int32_t* out_docs, float* out_scores,
                     std::vector<float>& acc, std::vector<int32_t>& touched) {
  touched.clear();
  for (int64_t qi = 0; qi < n_terms; ++qi) {
    const int32_t t = terms[qi];
    if (t < 0 || t >= idx.n_terms) continue;
    const float idf = idfs[qi];
    const int64_t begin = idx.term_offsets[t];
    const int64_t end = idx.term_offsets[t + 1];
    for (int64_t p = begin; p < end; ++p) {
      const int32_t d = idx.post_docs[p];
      const float tf = static_cast<float>(idx.post_freqs[p]);
      const float norm =
          static_cast<float>(k1 * (1.0 - b + b * idx.doc_lens[d] / idx.avgdl));
      const float s = idf * tf / (tf + norm);
      if (acc[d] == 0.0f) touched.push_back(d);
      acc[d] += s;
    }
  }
  // partial top-k over touched docs
  std::vector<Hit> hits;
  hits.reserve(touched.size());
  for (int32_t d : touched) {
    hits.push_back({acc[d], d});
    acc[d] = 0.0f;  // reset for next query
  }
  const size_t k = std::min(static_cast<size_t>(top_k), hits.size());
  std::partial_sort(hits.begin(), hits.begin() + k, hits.end(), hit_less);
  for (size_t i = 0; i < static_cast<size_t>(top_k); ++i) {
    if (i < k) {
      out_docs[i] = hits[i].doc;
      out_scores[i] = hits[i].score;
    } else {
      out_docs[i] = -1;
      out_scores[i] = 0.0f;
    }
  }
}

}  // namespace

extern "C" {

void* bm25_index_new(int64_t n_docs, const int32_t* doc_lens, int64_t n_terms,
                     const int64_t* term_offsets, const int32_t* post_docs,
                     const int32_t* post_freqs, int copy) {
  auto* idx = new Index();
  idx->n_docs = n_docs;
  idx->n_terms = n_terms;
  double total = 0.0;
  for (int64_t i = 0; i < n_docs; ++i) total += doc_lens[i];
  idx->avgdl = n_docs > 0 ? total / static_cast<double>(n_docs) : 1.0;
  if (copy) {
    idx->doc_lens_copy.assign(doc_lens, doc_lens + n_docs);
    idx->term_offsets_copy.assign(term_offsets, term_offsets + n_terms + 1);
    const int64_t n_post = term_offsets[n_terms];
    idx->post_docs_copy.assign(post_docs, post_docs + n_post);
    idx->post_freqs_copy.assign(post_freqs, post_freqs + n_post);
    idx->doc_lens = idx->doc_lens_copy.data();
    idx->term_offsets = idx->term_offsets_copy.data();
    idx->post_docs = idx->post_docs_copy.data();
    idx->post_freqs = idx->post_freqs_copy.data();
  } else {
    idx->doc_lens = doc_lens;
    idx->term_offsets = term_offsets;
    idx->post_docs = post_docs;
    idx->post_freqs = post_freqs;
  }
  return idx;
}

void bm25_index_free(void* handle) { delete static_cast<Index*>(handle); }

// Batched search. query_offsets is CSR over flattened query terms/idfs.
void bm25_search_batch(void* handle, const int32_t* query_terms,
                       const float* query_idfs, const int64_t* query_offsets,
                       int64_t n_queries, double k1, double b, int top_k,
                       int n_threads, int32_t* out_docs, float* out_scores) {
  const Index& idx = *static_cast<Index*>(handle);
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    std::vector<float> acc(idx.n_docs, 0.0f);
    std::vector<int32_t> touched;
    while (true) {
      const int64_t q = next.fetch_add(1);
      if (q >= n_queries) break;
      const int64_t begin = query_offsets[q];
      const int64_t end = query_offsets[q + 1];
      score_one_query(idx, query_terms + begin, end - begin, query_idfs + begin,
                      k1, b, top_k, out_docs + q * top_k,
                      out_scores + q * top_k, acc, touched);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // extern "C"
