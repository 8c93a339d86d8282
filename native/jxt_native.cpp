// jxt_native: host-side native core for the jxl_jax framework.
//
// Plays the role the reference delegates to native code (its Rust harness's
// stream plumbing plus libjxl's C++ entropy coder): a reference
// implementation of the exact same K-lane interleaved rANS scheme the JAX
// codec runs on device (32-bit state, 16-bit renorm words, 12-bit
// frequencies), plus fast ragged stream (de)serialization and raw-bit
// packing. Used via ctypes for:
//   - conformance: C++ encode == device encode, C++ decode(device stream)
//     == tokens (bit-exactness across implementations),
//   - fast host-side fallback when no accelerator is present.
//
// ABI: plain C functions; all buffers caller-allocated numpy arrays.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kPrec = 12;
constexpr uint32_t kM = 1u << kPrec;
constexpr uint32_t kL = 1u << 16;

}  // namespace

extern "C" {

// Interleaved rANS encode with CONSUMPTION-ORDER stream output (matching
// jxl_jax.entropy.rans): words appear in the order the decoder reads them —
// ascending decode step, then ascending lane among the lanes that
// renormalize at that step.
// tokens/ctx: [n]; freq/cum: [n_ctx * alphabet] (row-major).
// out_words: [cap_words]; out_n_words: scalar; out_states: [lanes].
// Returns 0 on success, -1 if the stream overflows cap_words.
int rans_encode(const int32_t* tokens, const int32_t* ctx, int64_t n,
                const uint32_t* freq, const uint32_t* cum, int32_t alphabet,
                int32_t lanes, int64_t cap_words, uint16_t* out_words,
                int64_t* out_n_words, uint32_t* out_states) {
  std::vector<uint32_t> states(lanes, kL);
  // (step, lane, word) triples, gathered while walking symbols in reverse.
  std::vector<std::pair<int64_t, uint16_t>> emits;  // key = step*lanes+lane
  for (int64_t i = n - 1; i >= 0; --i) {
    int lane = static_cast<int>(i % lanes);
    uint32_t x = states[lane];
    int32_t s = tokens[i];
    int64_t row = static_cast<int64_t>(ctx[i]) * alphabet;
    uint32_t f = freq[row + s];
    uint32_t c = cum[row + s];
    if (x >= (f << 20)) {
      emits.emplace_back(i / lanes * static_cast<int64_t>(lanes) + lane,
                         static_cast<uint16_t>(x & 0xFFFF));
      x >>= 16;
    }
    states[lane] = ((x / f) << kPrec) + (x % f) + c;
  }
  if (static_cast<int64_t>(emits.size()) > cap_words) return -1;
  // Reverse walk produced descending keys; consumption order is ascending.
  int64_t nw = static_cast<int64_t>(emits.size());
  for (int64_t j = 0; j < nw; ++j) {
    out_words[j] = emits[nw - 1 - j].second;
  }
  // keys are strictly decreasing during the reverse walk, so the plain
  // reversal above already yields ascending (step, lane) order.
  *out_n_words = nw;
  for (int k = 0; k < lanes; ++k) out_states[k] = states[k];
  return 0;
}

// Decode from a consumption-order stream.
int rans_decode(const uint16_t* words, int64_t n_words,
                const uint32_t* states_in, int64_t n, const int32_t* ctx,
                const uint32_t* freq, const uint32_t* cum, int32_t alphabet,
                int32_t lanes, int32_t* out_tokens) {
  std::vector<uint32_t> states(states_in, states_in + lanes);
  int64_t gptr = 0;
  for (int64_t i = 0; i < n; ++i) {
    int lane = static_cast<int>(i % lanes);
    uint32_t x = states[lane];
    uint32_t slot = x & (kM - 1);
    int64_t row = static_cast<int64_t>(ctx[i]) * alphabet;
    // symbol = last s with cum[s] <= slot
    int32_t s = alphabet - 1;
    while (s > 0 && cum[row + s] > slot) --s;
    uint32_t f = freq[row + s];
    x = f * (x >> kPrec) + slot - cum[row + s];
    if (x < kL) {
      if (gptr >= n_words) return -1;
      x = (x << 16) | words[gptr++];
    }
    states[lane] = x;
    out_tokens[i] = s;
  }
  if (gptr != n_words) return -2;
  return 0;
}

// Raw-bit packing, MSB-first, identical to entropy/tokens.py pack_bits.
void pack_bits(const int32_t* nbits, const uint32_t* mantissa, int64_t n,
               uint32_t* out_words, int64_t n_words) {
  std::memset(out_words, 0, sizeof(uint32_t) * n_words);
  int64_t pos = 0;
  for (int64_t i = 0; i < n; ++i) {
    for (int32_t b = 0; b < nbits[i]; ++b) {
      uint32_t bit = (mantissa[i] >> (nbits[i] - 1 - b)) & 1u;
      int64_t word = (pos + b) >> 5;
      int32_t in_word = static_cast<int32_t>((pos + b) & 31);
      out_words[word] |= bit << (31 - in_word);
    }
    pos += nbits[i];
  }
}

void unpack_bits(const int32_t* nbits, const uint32_t* words, int64_t n,
                 uint32_t* out_mantissa) {
  int64_t pos = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint32_t v = 0;
    for (int32_t b = 0; b < nbits[i]; ++b) {
      int64_t word = (pos + b) >> 5;
      int32_t in_word = static_cast<int32_t>((pos + b) & 31);
      v |= ((words[word] >> (31 - in_word)) & 1u) << (nbits[i] - 1 - b);
    }
    out_mantissa[i] = v;
    pos += nbits[i];
  }
}

}  // extern "C"
