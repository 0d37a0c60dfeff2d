// Native BoW tokenizer/vectorizer — the host-side data-layer hot path.
//
// The reference vectorizes every client corpus against the global vocabulary
// with sklearn's CountVectorizer (client.py:460-468); at production corpus
// sizes that is millions of Python-dict token lookups per client. This
// implements the same semantics for ASCII text (the Python layer verifies
// ASCII-ness and falls back otherwise, so parity is exact):
//
//   token pattern \b\w\w+\b over ASCII \w = [A-Za-z0-9_]  ==  maximal runs
//   of word characters of length >= 2; optional ASCII lowercasing.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in the build image).
// Documents and vocabularies cross the boundary as one contiguous blob plus
// an offsets array — one copy, no per-string marshalling.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

inline bool is_word(unsigned char c) {
    return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
           (c >= '0' && c <= '9') || c == '_';
}

inline char lower(char c) {
    return (c >= 'A' && c <= 'Z') ? static_cast<char>(c + 32) : c;
}

// Calls fn(token) for every >=2-char word-character run in [begin, end).
// When lowercasing, the token is materialized into `scratch`.
template <typename Fn>
void for_each_token(const char* begin, const char* end, bool lowercase,
                    std::string& scratch, Fn&& fn) {
    const char* p = begin;
    while (p < end) {
        while (p < end && !is_word(static_cast<unsigned char>(*p))) ++p;
        const char* start = p;
        while (p < end && is_word(static_cast<unsigned char>(*p))) ++p;
        if (p - start >= 2) {
            if (lowercase) {
                scratch.assign(start, p - start);
                for (char& c : scratch) c = lower(c);
                fn(std::string_view(scratch));
            } else {
                fn(std::string_view(start, p - start));
            }
        }
    }
}

using VocabMap = std::unordered_map<std::string_view, int64_t>;

VocabMap build_map(const char* blob, const int64_t* offsets, int64_t n) {
    VocabMap map;
    map.reserve(static_cast<size_t>(n) * 2);
    for (int64_t i = 0; i < n; ++i) {
        map.emplace(
            std::string_view(blob + offsets[i], offsets[i + 1] - offsets[i]),
            i);
    }
    return map;
}

}  // namespace

extern "C" {

// Dense count matrix [n_docs, n_vocab] (float32, row-major) of each doc's
// tokens against a FIXED vocabulary; unknown tokens are dropped
// (CountVectorizer transform semantics). Returns 0.
int gfed_vectorize(const char* docs_blob, const int64_t* doc_offsets,
                   int64_t n_docs, const char* vocab_blob,
                   const int64_t* vocab_offsets, int64_t n_vocab,
                   int lowercase, float* out) {
    VocabMap vocab = build_map(vocab_blob, vocab_offsets, n_vocab);
    std::string scratch;
    for (int64_t d = 0; d < n_docs; ++d) {
        float* row = out + d * n_vocab;
        for_each_token(docs_blob + doc_offsets[d], docs_blob + doc_offsets[d + 1],
                       lowercase != 0, scratch,
                       [&](std::string_view tok) {
                           auto it = vocab.find(tok);
                           if (it != vocab.end()) row[it->second] += 1.0f;
                       });
    }
    return 0;
}

// Corpus-wide term -> document-count-independent frequency map (total token
// occurrences, what CountVectorizer's max_features ranks by). Results are
// returned as one \n-joined token blob + parallel counts array, both
// allocated here; free with gfed_free. Returns the number of distinct terms,
// or -1 on allocation failure.
int64_t gfed_count_terms(const char* docs_blob, const int64_t* doc_offsets,
                         int64_t n_docs, int lowercase, char** out_tokens,
                         int64_t* out_tokens_len, int64_t** out_counts) {
    std::unordered_map<std::string, int64_t> counts;
    std::string scratch;
    for (int64_t d = 0; d < n_docs; ++d) {
        for_each_token(docs_blob + doc_offsets[d], docs_blob + doc_offsets[d + 1],
                       lowercase != 0, scratch,
                       [&](std::string_view tok) { counts[std::string(tok)] += 1; });
    }

    size_t blob_len = 0;
    for (const auto& kv : counts) blob_len += kv.first.size() + 1;

    char* blob = static_cast<char*>(std::malloc(blob_len ? blob_len : 1));
    int64_t* cnts = static_cast<int64_t*>(
        std::malloc(sizeof(int64_t) * (counts.empty() ? 1 : counts.size())));
    if (blob == nullptr || cnts == nullptr) {
        std::free(blob);
        std::free(cnts);
        return -1;
    }

    char* w = blob;
    int64_t i = 0;
    for (const auto& kv : counts) {
        std::memcpy(w, kv.first.data(), kv.first.size());
        w += kv.first.size();
        *w++ = '\n';
        cnts[i++] = kv.second;
    }
    *out_tokens = blob;
    *out_tokens_len = static_cast<int64_t>(blob_len);
    *out_counts = cnts;
    return static_cast<int64_t>(counts.size());
}

void gfed_free(void* p) { std::free(p); }

}  // extern "C"
