// Fast whitespace-delimited numeric table parser for MCMC chain files.
//
// The reference framework parses CosmoMC text chains with np.loadtxt
// (reference MCEvidence.py:560-565), the slowest part of its host pipeline
// for the Planck full-grid workload.  This parser mmaps the file once and
// converts each number once (no line splitting, no Python object churn).
//
// C ABI (used from Python via ctypes, see chainload.py):
//   h = chainload_open(path, slices, &rows_bound, &ncols)
//     maps the file and cuts it into `slices` runs of whole lines; rows_bound
//     is its newline count (plus one for a last line without '\n'), ncols
//     the number of values on its first data line.  NULL on error
//     (unreadable or empty file, a bad first line).
//   chainload_fill(h, out, capacity, &nrows, &nfixed)
//     converts every data line into out (row-major) up to `capacity`
//     doubles, one thread a slice; nrows gets the rows written, nfixed the
//     values the fixed-layout decoder took.  Returns the number of doubles
//     written, or -1 on error (an unparsable or over-long token, a ragged
//     row, a capacity overrun, in any slice).
//   chainload_close(h) unmaps the file.
//
// Lines starting with '#' (after leading spaces) are comments.  Column count
// is fixed by the first data line; ragged rows are an error.
//
// Slices: the byte offsets size * j / slices, each moved forward past the
// next '\n', cut the file; the scan that counts its newlines records each
// slice's start and the lines before it.  A slice writes its rows from that
// line count on (a data row is one line, so it writes no further than its
// own lines), and after the join its rows move down over the rows that
// blank and comment lines before it did not fill.  Every line decodes as in
// a one-slice parse, since a slice ends just past a '\n' that ends its last
// line: the table is the same bit for bit.

#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <system_error>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

inline bool is_space(char c) {
  return c == ' ' || c == '\t' || c == '\r';
}

inline bool ends_token(const char* s, const char* end) {
  return s == end || is_space(*s) || *s == '\n';
}

// Eight bytes at p as a little-endian word: byte i of the text is bits
// 8i..8i+7, whatever the machine's byte order.
inline uint64_t load_le(const char* p) {
  uint64_t w;
  memcpy(&w, p, 8);
#if __BYTE_ORDER__ == __ORDER_BIG_ENDIAN__
  w = __builtin_bswap64(w);
#endif
  return w;
}

inline unsigned byte_at(uint64_t w, int i) {
  return static_cast<unsigned>(w >> (8 * i)) & 0xFF;
}

// The 8 decimal digits of w (first byte most significant) as an integer,
// if every byte is a digit.
inline bool eight_digits(uint64_t w, uint32_t* out) {
  if (((w + 0x4646464646464646ULL) | (w - 0x3030303030303030ULL)) &
      0x8080808080808080ULL) {
    return false;
  }
  // pairs, then quads, then the eight, by multiply-and-shift
  w -= 0x3030303030303030ULL;
  w = w * 10 + (w >> 8);
  w = (((w & 0x000000FF000000FFULL) * 0x000F424000000064ULL) +
       (((w >> 16) & 0x000000FF000000FFULL) * 0x0000271000000001ULL)) >>
      32;
  *out = static_cast<uint32_t>(w);
  return true;
}

// 10^max(k, 0) and 10^max(-k, 0) at [k + 22] for |k| <= 22: one of the two
// is 1, so m * kScaleUp[i] / kScaleDown[i] is one rounding of m * 10^k,
// without a branch on the sign of k.
const double kScaleUp[45] = {
    1,    1,    1,    1,    1,    1,    1,    1,    1,    1,    1,    1,
    1,    1,    1,    1,    1,    1,    1,    1,    1,    1,    1,    1e1,
    1e2,  1e3,  1e4,  1e5,  1e6,  1e7,  1e8,  1e9,  1e10, 1e11, 1e12, 1e13,
    1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};
const double kScaleDown[45] = {
    1e22, 1e21, 1e20, 1e19, 1e18, 1e17, 1e16, 1e15, 1e14, 1e13, 1e12, 1e11,
    1e10, 1e9,  1e8,  1e7,  1e6,  1e5,  1e4,  1e3,  1e2,  1e1,  1,    1,
    1,    1,    1,    1,    1,    1,    1,    1,    1,    1,    1,    1,
    1,    1,    1,    1,    1,    1,    1,    1,    1};

// Whether c, a byte below 64, is in the set `mask`, without a branch per
// member: which of them a field holds varies from field to field.
inline bool one_of(unsigned c, uint64_t mask) {
  return c < 64 && ((1ULL << c) & mask);
}
const uint64_t kSigns = (1ULL << '+') | (1ULL << '-');
const uint64_t kSeparators =
    (1ULL << ' ') | (1ULL << '\t') | (1ULL << '\r') | (1ULL << '\n');

// CosmoMC writes every number as %16.7E: [+-]d.dddddddE[+-]dd, right-aligned
// in a field of 16 bytes.  decode_fixed reads such a token by position,
// from s at its first digit, from two words: its 8 digits are an integer
// m < 2^53 and the value is m * 10^(e-7), so within |e-7| <= 22 one exact
// multiply or divide gives strtod's bits (the same argument as
// parse_double_fast, without its byte-by-byte scan).  The signs are
// applied by arithmetic, not branches: they vary from field to field.
inline bool decode_fixed(const char* s, const char* end, uint64_t neg,
                         double* out) {
  // a: "d.dddddd", b: "dE+dd" and the byte after the token; past the end
  // of the file the bytes read '\n'
  uint64_t a, b;
  if (end - s >= 16) {
    a = load_le(s);
    b = load_le(s + 8);
  } else {
    if (end - s < 13) return false;
    char tail[16];
    memset(tail, '\n', sizeof(tail));
    memcpy(tail, s, end - s);
    a = load_le(tail);
    b = load_le(tail + 8);
  }
  const unsigned sep = byte_at(b, 5);
  const unsigned esign = byte_at(b, 2);
  if (byte_at(a, 1) != '.' || byte_at(b, 1) != 'E' ||
      !one_of(esign, kSigns) || !one_of(sep, kSeparators)) {
    return false;
  }
  // the digits d0 d1..d6 d7, the '.' taken out
  const uint64_t w = (a & 0xFF) | ((a >> 8) & 0x00FFFFFFFFFFFF00ULL) |
                     (b << 56);
  uint32_t m;
  const unsigned e1 = byte_at(b, 3) - '0';
  const unsigned e0 = byte_at(b, 4) - '0';
  if (!eight_digits(w, &m) || e1 > 9 || e0 > 9) return false;
  const int eneg = esign == '-';
  const int e10 = static_cast<int>(e1 * 10 + e0);
  const int i = ((e10 ^ -eneg) + eneg) - 7 + 22;  // 10^(e-7) at [i]
  if (static_cast<unsigned>(i) > 44) return false;
  const double v = static_cast<double>(m) * kScaleUp[i] / kScaleDown[i];
  uint64_t bits;
  memcpy(&bits, &v, 8);
  bits |= neg << 63;
  memcpy(out, &bits, 8);
  return true;
}

// A token at p (its sign or first digit) in the fixed layout.
inline bool parse_fixed_e(const char* p, const char* end, double* out,
                          const char** next) {
  const uint64_t neg = *p == '-';
  const char* s = p + (neg | (*p == '+'));
  if (!decode_fixed(s, end, neg, out)) return false;
  *next = s + 13;
  return true;
}

// A whole 16-byte field at c, "  " then a sign or a space then the token,
// as the field after a %16.7E token starts where that token ends.  Its end
// is c + 16 whatever its bytes, so a row's fields are found without a scan
// and decoded independently of one another.
inline bool parse_fixed_field(const char* c, const char* end, double* out) {
  if (end - c < 16 || c[0] != ' ' || c[1] != ' ') return false;
  const unsigned sign = static_cast<unsigned char>(c[2]);
  if (!one_of(sign, kSigns | (1ULL << ' '))) return false;
  return decode_fixed(c + 3, end, sign == '-', out);
}

// Fast float path (Clinger): for mantissas of <= 15 significant digits and
// decimal exponents within +/-22, m * 10^e is exactly representable as the
// product of two exactly-representable doubles, so one multiplication gives
// the correctly rounded result — identical to strtod.  Chain files
// (%.*E columns) are almost always in this regime; anything else falls back
// to strtod.  ~6x faster than glibc strtod on chain-shaped input.
const double kPow10[23] = {
    1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,  1e8,  1e9,  1e10, 1e11,
    1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};

inline bool parse_double_fast(const char* p, const char* end, double* out,
                              const char** next) {
  const char* s = p;
  bool neg = false;
  if (s < end && (*s == '-' || *s == '+')) {
    neg = (*s == '-');
    ++s;
  }
  uint64_t mant = 0;
  int digits = 0;
  int dexp = 0;
  bool any = false;
  while (s < end && *s >= '0' && *s <= '9') {
    any = true;
    if (digits < 19) {
      mant = mant * 10 + static_cast<uint64_t>(*s - '0');
      ++digits;
    } else {
      ++dexp;  // overflow digits shift the exponent
    }
    ++s;
  }
  if (s < end && *s == '.') {
    ++s;
    while (s < end && *s >= '0' && *s <= '9') {
      any = true;
      if (digits < 19) {
        mant = mant * 10 + static_cast<uint64_t>(*s - '0');
        ++digits;
        --dexp;
      }
      ++s;
    }
  }
  if (!any) return false;
  if (s < end && (*s == 'e' || *s == 'E' || *s == 'd' || *s == 'D')) {
    const char* es = s + 1;
    bool eneg = false;
    if (es < end && (*es == '-' || *es == '+')) {
      eneg = (*es == '-');
      ++es;
    }
    if (es >= end || *es < '0' || *es > '9') return false;
    int ev = 0;
    while (es < end && *es >= '0' && *es <= '9') {
      ev = ev * 10 + (*es - '0');
      if (ev > 9999) return false;
      ++es;
    }
    dexp += eneg ? -ev : ev;
    s = es;
  }
  // token must end at whitespace/newline to be a clean number
  if (!ends_token(s, end)) return false;
  // exactness window: mantissa fits in 2^53 and |exp| <= 22
  if (mant >> 53 || dexp > 22 || dexp < -22 || digits > 15) return false;
  double v = static_cast<double>(mant);
  v = dexp >= 0 ? v * kPow10[dexp] : v / kPow10[-dexp];
  *out = neg ? -v : v;
  *next = s;
  return true;
}

// strtod needs a NUL-terminated string but the mmap'd buffer is not
// NUL-terminated: copy the token to a bounded stack buffer first (reading
// past `end` is an out-of-bounds access on page-aligned files with no
// trailing newline).  A token longer than the buffer is refused:
// truncating would silently parse the tail as extra columns.
inline bool parse_strtod(const char* p, const char* end, double* out,
                         const char** next) {
  char tok[128];
  size_t len = 0;
  const char* t = p;
  while (t < end && !is_space(*t) && *t != '\n' && len < sizeof(tok) - 1) {
    tok[len++] = *t++;
  }
  if (t < end && !is_space(*t) && *t != '\n') return false;
  tok[len] = '\0';
  char* stop = nullptr;
  errno = 0;
  *out = strtod(tok, &stop);
  if (stop == tok) return false;  // unparsable token
  *next = p + (stop - tok);
  return true;
}

// Moves p past blank and comment lines to the first byte of the next data
// line, or to end.
inline const char* skip_to_data(const char* p, const char* end) {
  while (p < end) {
    while (p < end && is_space(*p)) ++p;
    if (p < end && *p == '\n') {  // blank line
      ++p;
    } else if (p < end && *p == '#') {  // comment line
      while (p < end && *p != '\n') ++p;
    } else {
      break;
    }
  }
  return p;
}

// Converts the values of the data line at p, calling emit(value, fixed)
// for each, and moves p past its '\n'.  Returns the number of values, or
// -1 where a token does not parse or emit refuses one.
template <class Emit>
inline long long parse_line(const char** pp, const char* end, Emit emit) {
  const char* p = *pp;
  long long n = 0;
  while (p < end && *p != '\n') {
    double v;
    if (parse_fixed_field(p, end, &v)) {
      if (!emit(v, true)) return -1;
      ++n;
      p += 16;
      continue;
    }
    while (p < end && is_space(*p)) ++p;
    if (p >= end || *p == '\n') break;
    const char* next = nullptr;
    const bool fixed = parse_fixed_e(p, end, &v, &next);
    if (!fixed && !parse_double_fast(p, end, &v, &next) &&
        !parse_strtod(p, end, &v, &next)) {
      return -1;
    }
    if (!emit(v, fixed)) return -1;
    ++n;
    p = next;
  }
  if (p < end) ++p;  // the '\n'
  *pp = p;
  return n;
}

struct Table {
  const char* data;
  size_t size;
  long long cols;
  // slice j is data[start[j], start[j + 1]), after before[j] lines
  std::vector<size_t> start;
  std::vector<long long> before;
};

// What one slice wrote at out + first_row * cols.
struct SliceResult {
  long long first_row = 0;
  long long rows = 0;
  long long fixed = 0;
  bool ok = true;
};

void fill_slice(const Table& t, size_t j, double* out, long long capacity,
                SliceResult* r) {
  const char* p = t.data + t.start[j];
  const char* end = t.data + t.start[j + 1];
  r->first_row = t.before[j];
  // its own lines' room, within the caller's capacity
  long long room = (t.before[j + 1] - t.before[j]) * t.cols;
  const long long left = capacity - r->first_row * t.cols;
  if (left < room) room = left < 0 ? 0 : left;
  double* dst = out + r->first_row * t.cols;
  long long written = 0, fixed = 0;
  auto emit = [&](double v, bool f) {
    if (written >= room) return false;
    dst[written++] = v;
    fixed += f;
    return true;
  };
  long long rows = 0;
  for (p = skip_to_data(p, end); p < end; p = skip_to_data(p, end)) {
    // a bad token, an overrun or a ragged row
    if (parse_line(&p, end, emit) != t.cols) {
      r->ok = false;
      return;
    }
    ++rows;
  }
  r->rows = rows;
  r->fixed = fixed;
}

}  // namespace

extern "C" void* chainload_open(const char* path, long long slices,
                                long long* rows_bound, long long* ncols) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0) {
    ::close(fd);
    return nullptr;
  }
  size_t size = static_cast<size_t>(st.st_size);
  const char* data = static_cast<const char*>(
      mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0));
  ::close(fd);
  if (data == MAP_FAILED) return nullptr;
  madvise(const_cast<char*>(data), size, MADV_SEQUENTIAL);

  // one scan counts the newlines and finds each slice's start: the first
  // '\n' at or past its offset ends the slice before it
  const size_t s = slices < 1 ? 1 : static_cast<size_t>(slices);
  std::vector<size_t> start(s + 1, size);
  std::vector<long long> before(s + 1, 0);
  start[0] = 0;
  const char* end = data + size;
  long long newlines = 0;
  size_t j = 1;
  for (const char* p = data;
       (p = static_cast<const char*>(memchr(p, '\n', end - p))) != nullptr;
       ++p) {
    ++newlines;
    const size_t at = static_cast<size_t>(p - data);
    for (; j < s && at >= size * j / s; ++j) {
      start[j] = at + 1;
      before[j] = newlines;
    }
  }
  const long long lines = newlines + (end[-1] != '\n');
  for (; j <= s; ++j) before[j] = lines;
  const char* first = skip_to_data(data, end);
  const long long cols =
      parse_line(&first, end, [](double, bool) { return true; });
  if (cols < 0) {
    munmap(const_cast<char*>(data), size);
    return nullptr;
  }
  *rows_bound = lines;
  *ncols = cols;
  return new Table{data, size, cols, std::move(start), std::move(before)};
}

extern "C" long long chainload_fill(void* handle, double* out,
                                    long long capacity, long long* nrows,
                                    long long* nfixed) {
  const Table& t = *static_cast<const Table*>(handle);
  // slice 0 on the calling thread, each other on a thread of its own
  std::vector<SliceResult> res(t.start.size() - 1);
  std::vector<std::thread> threads;
  threads.reserve(res.size());
  for (size_t j = 1; j < res.size(); ++j) {
    try {
      threads.emplace_back(fill_slice, std::cref(t), j, out, capacity,
                           &res[j]);
    } catch (const std::system_error&) {  // no thread to be had: decode here
      fill_slice(t, j, out, capacity, &res[j]);
    }
  }
  fill_slice(t, 0, out, capacity, &res[0]);
  for (std::thread& th : threads) th.join();
  long long rows = 0, fixed = 0;
  for (const SliceResult& r : res) {
    if (!r.ok) return -1;
    // close the gap that blank and comment lines left before the slice
    if (r.first_row != rows && r.rows > 0) {
      memmove(out + rows * t.cols, out + r.first_row * t.cols,
              sizeof(double) * r.rows * t.cols);
    }
    rows += r.rows;
    fixed += r.fixed;
  }
  *nrows = rows;
  *nfixed = fixed;
  return rows * t.cols;
}

extern "C" void chainload_close(void* handle) {
  Table* t = static_cast<Table*>(handle);
  munmap(const_cast<char*>(t->data), t->size);
  delete t;
}
