// Native host-side kernels for the presto-tpu-torch worker data plane (the
// port's copy of presto_tpu/native/kernels.cpp).
//
// The reference worker's shell is C++ (presto-native-execution/presto_cpp);
// the worker keeps device compute in PyTorch and CUDA and uses this library
// for the host-side per-row hot loops outside the device: SQL LIKE matching
// (reference LikeFunctions semantics: only % and _ are wildcards, optional
// escape character) and dictionary encoding of substrings over packed string
// buffers.  Strings arrive as one contiguous byte buffer plus an int64
// offsets array of length n+1 (Arrow-style layout); all semantics are
// byte-wise, callers guarantee ASCII (the Python wrapper falls back to the
// pure-Python matcher otherwise).
//
// C ABI only: loaded via ctypes, no pybind11 dependency.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum TokKind : uint8_t { LIT = 0, ANY = 1, STAR = 2 };

struct Tok {
  TokKind kind;
  char c;
};

// Compile a LIKE pattern into tokens; escape < 0 means no escape character.
std::vector<Tok> compile_pattern(const char* pattern, int64_t len,
                                 int escape) {
  std::vector<Tok> toks;
  toks.reserve(static_cast<size_t>(len));
  for (int64_t i = 0; i < len; ++i) {
    char ch = pattern[i];
    if (escape >= 0 && ch == static_cast<char>(escape) && i + 1 < len) {
      toks.push_back({LIT, pattern[++i]});
    } else if (ch == '%') {
      if (toks.empty() || toks.back().kind != STAR) toks.push_back({STAR, 0});
    } else if (ch == '_') {
      toks.push_back({ANY, 0});
    } else {
      toks.push_back({LIT, ch});
    }
  }
  return toks;
}

// Greedy wildcard match with backtracking over the last '%'.
bool match_one(const char* s, int64_t slen, const Tok* toks, int64_t ntoks) {
  int64_t si = 0, ti = 0, star_ti = -1, star_si = 0;
  while (si < slen) {
    if (ti < ntoks && (toks[ti].kind == ANY ||
                       (toks[ti].kind == LIT && toks[ti].c == s[si]))) {
      ++ti;
      ++si;
    } else if (ti < ntoks && toks[ti].kind == STAR) {
      star_ti = ti++;
      star_si = si;
    } else if (star_ti >= 0) {
      ti = star_ti + 1;
      si = ++star_si;
    } else {
      return false;
    }
  }
  while (ti < ntoks && toks[ti].kind == STAR) ++ti;
  return ti == ntoks;
}

// Binary search `needle` in a packed sorted dictionary; -1 if absent.
int32_t dict_find(const char* dict_data, const int64_t* dict_offsets,
                  int32_t dict_n, const char* needle, int64_t nlen) {
  int32_t lo = 0, hi = dict_n - 1;
  while (lo <= hi) {
    int32_t mid = lo + (hi - lo) / 2;
    const char* e = dict_data + dict_offsets[mid];
    int64_t elen = dict_offsets[mid + 1] - dict_offsets[mid];
    int64_t common = elen < nlen ? elen : nlen;
    int cmp = std::memcmp(e, needle, static_cast<size_t>(common));
    if (cmp == 0) cmp = (elen > nlen) - (elen < nlen);
    if (cmp == 0) return mid;
    if (cmp < 0)
      lo = mid + 1;
    else
      hi = mid - 1;
  }
  return -1;
}

}  // namespace

extern "C" {

// out[i] = 1 iff strings[i] matches the LIKE pattern.
void ptn_like(const char* data, const int64_t* offsets, int64_t n,
              const char* pattern, int64_t pattern_len, int escape,
              uint8_t* out) {
  std::vector<Tok> toks = compile_pattern(pattern, pattern_len, escape);
  const Tok* t = toks.data();
  int64_t nt = static_cast<int64_t>(toks.size());
  for (int64_t i = 0; i < n; ++i) {
    out[i] = match_one(data + offsets[i], offsets[i + 1] - offsets[i], t, nt)
                 ? 1
                 : 0;
  }
}

// SQL substr(s, start, length) of each input (1-based start; negative start
// counts from the end; length < 0 means "to the end"), then encode against a
// packed SORTED dictionary.  Returns the number of values not found in the
// dictionary (their codes are set to -1).
int64_t ptn_substr_dict_encode(const char* data, const int64_t* offsets,
                               int64_t n, int64_t start, int64_t length,
                               const char* dict_data,
                               const int64_t* dict_offsets, int32_t dict_n,
                               int32_t* out_codes) {
  int64_t missing = 0;
  for (int64_t i = 0; i < n; ++i) {
    const char* s = data + offsets[i];
    int64_t slen = offsets[i + 1] - offsets[i];
    // mirror the Python oracle (_py_substr) exactly, including Python slice
    // semantics when the adjusted start is still negative: s[b0:e0] re-bases
    // negative bounds off the end and clamps to [0, slen]
    int64_t b0 = start > 0 ? start - 1 : slen + start;
    int64_t e0 = length < 0 ? slen : b0 + length;
    int64_t b = b0 >= 0 ? (b0 < slen ? b0 : slen)
                        : (slen + b0 > 0 ? slen + b0 : 0);
    int64_t e = e0 >= 0 ? (e0 < slen ? e0 : slen)
                        : (slen + e0 > 0 ? slen + e0 : 0);
    if (e < b) e = b;
    int32_t code = dict_find(dict_data, dict_offsets, dict_n, s + b, e - b);
    out_codes[i] = code;
    if (code < 0) ++missing;
  }
  return missing;
}

// Combined splitmix64 hash of an int64 column into an accumulator array,
// matching exec/operators.py splitmix64 / hash_columns (h = mix(h*31 + mix(v))).
void ptn_hash_combine(const int64_t* values, const uint8_t* nulls, int64_t n,
                      uint64_t* inout) {
  const uint64_t GOLDEN = 0x9E3779B97F4A7C15ULL;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t x = static_cast<uint64_t>(values[i]);
    x += GOLDEN;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
    x = x ^ (x >> 31);
    if (nulls != nullptr && nulls[i]) x = GOLDEN;
    uint64_t h = inout[i] * 31ULL + x;
    h += GOLDEN;
    h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9ULL;
    h = (h ^ (h >> 27)) * 0x94D049BB133111EBULL;
    inout[i] = h ^ (h >> 31);
  }
}

}  // extern "C"
