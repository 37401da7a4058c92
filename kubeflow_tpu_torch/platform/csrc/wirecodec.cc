// wirecodec.cc — structural scanner for the watch-event fast path.
//
//   kfw_*  — locate the envelope fields of one watch line
//            ({"type": ..., "object": {... "metadata": {...} ...}})
//            WITHOUT building a document tree.  The Python side slices
//            the returned byte ranges out of the original line, decodes
//            only the (small) metadata object eagerly, and defers the
//            full body until the informer actually admits the object.
//
// This is deliberately a *scanner*, not a validator: it tracks strings,
// escapes and brace/bracket depth precisely, but does not check number
// grammar or literal spelling.  The Python wrapper json.loads()es every
// slice it extracts, so a line the scanner mis-ranges fails there and
// falls back to a full-document json.loads — wrong output is impossible,
// only a slow path.
//
// ABI (mirrors packer.cc's out-array style): offsets written into a
// caller-provided int64 array, 0 on success, -1 on error with the
// message available from kfw_last_error().

#include <cstdint>
#include <cstring>
#include <string>

namespace {

// The five characters the container skip-loop must stop on; everything
// else is consumed at one table load per byte (the scan is the whole
// per-event native cost, so the inner loop matters).
const bool* structural_table() {
  static bool t[256] = {};
  static const bool init = [] {
    t[static_cast<unsigned char>('"')] = true;
    t[static_cast<unsigned char>('{')] = true;
    t[static_cast<unsigned char>('[')] = true;
    t[static_cast<unsigned char>('}')] = true;
    t[static_cast<unsigned char>(']')] = true;
    return true;
  }();
  (void)init;
  return t;
}

struct Scan {
  const char* p;
  const char* end;
  const char* err = nullptr;

  explicit Scan(const char* buf, int64_t len) : p(buf), end(buf + len) {}

  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
  }

  bool fail(const char* msg) {
    err = msg;
    return false;
  }

  // Find the next '"' or '\\' at or after p.  SWAR over 8-byte words:
  // k8s documents are mostly short strings, where memchr's per-call
  // setup costs more than it saves — one word load + two XOR masks per
  // 8 bytes beats both memchr and a byte loop.
  static const char* quote_or_escape(const char* p, const char* end) {
    constexpr uint64_t kOnes = 0x0101010101010101ULL;
    constexpr uint64_t kHigh = 0x8080808080808080ULL;
    constexpr uint64_t kQuote = 0x2222222222222222ULL;   // '"'
    constexpr uint64_t kSlash = 0x5C5C5C5C5C5C5C5CULL;   // '\\'
    while (p + 8 <= end) {
      uint64_t w;
      std::memcpy(&w, p, 8);
      uint64_t q = w ^ kQuote;
      uint64_t b = w ^ kSlash;
      uint64_t hit = ((q - kOnes) & ~q & kHigh) | ((b - kOnes) & ~b & kHigh);
      if (hit != 0) return p + (__builtin_ctzll(hit) >> 3);
      p += 8;
    }
    while (p < end && *p != '"' && *p != '\\') ++p;
    return p;
  }

  // Advance past one JSON string (p on the opening quote); the content
  // range (between the quotes) is returned via [cs, ce).
  bool str(const char** cs, const char** ce) {
    if (p >= end || *p != '"') return fail("expected string");
    ++p;
    *cs = p;
    const char* q = p;
    while (true) {
      q = quote_or_escape(q, end);
      if (q >= end) {
        p = end;
        return fail("unterminated string");
      }
      if (*q == '"') {
        *ce = q;
        p = q + 1;
        return true;
      }
      q += 2;  // escape pair
    }
  }

  // Advance past one JSON value of any kind.  Depth-counts containers,
  // skips strings with escape handling, and consumes number/literal
  // runs up to the next structural delimiter.
  bool value() {
    ws();
    if (p >= end) return fail("unexpected end of input");
    char c = *p;
    if (c == '"') {
      const char *s, *e;
      return str(&s, &e);
    }
    if (c == '{' || c == '[') {
      const bool* stop = structural_table();
      int depth = 0;
      while (p < end) {
        c = *p;
        if (!stop[static_cast<unsigned char>(c)]) {
          ++p;
          continue;
        }
        if (c == '"') {
          const char *s, *e;
          if (!str(&s, &e)) return false;
          continue;
        }
        if (c == '{' || c == '[') {
          ++depth;
        } else {
          --depth;
          if (depth == 0) {
            ++p;
            return true;
          }
        }
        ++p;
      }
      return fail("unterminated container");
    }
    // number / true / false / null — consume until a delimiter.
    while (p < end && *p != ',' && *p != '}' && *p != ']' && *p != ' ' &&
           *p != '\t' && *p != '\n' && *p != '\r')
      ++p;
    return true;
  }

  // Iterate the members of the object starting at p (on '{').  The
  // callback sees each key's content range positioned AT the value and
  // must consume it (typically via value(), or by recursing into
  // object_members for keys it wants to look inside — this is what
  // keeps the whole event a single pass).
  template <typename F>
  bool object_members(F&& consume_value) {
    ws();
    if (p >= end || *p != '{') return fail("expected object");
    ++p;
    ws();
    if (p < end && *p == '}') {
      ++p;
      return true;
    }
    while (true) {
      ws();
      const char *ks, *ke;
      if (!str(&ks, &ke)) return false;
      ws();
      if (p >= end || *p != ':') return fail("expected ':'");
      ++p;
      ws();
      if (!consume_value(ks, ke)) return false;
      ws();
      if (p < end && *p == ',') {
        ++p;
        continue;
      }
      if (p < end && *p == '}') {
        ++p;
        return true;
      }
      return fail("expected ',' or '}'");
    }
  }
};

bool key_is(const char* ks, const char* ke, const char* want) {
  size_t n = std::strlen(want);
  return static_cast<size_t>(ke - ks) == n && std::memcmp(ks, want, n) == 0;
}

thread_local std::string g_error;

}  // namespace

extern "C" {

const char* kfw_last_error() { return g_error.c_str(); }

// out[0..1]:  "type" value content (string, without quotes)
// out[2..3]:  "object" value (whole JSON value)
// out[4..5]:  "metadata" value inside object, or -1/-1 when absent
// out[6..7]:  metadata.name string content, or -1/-1 when not extracted
// out[8..9]:  metadata.namespace string content, ditto
// out[10..11]: metadata.resourceVersion string content, ditto
//
// The three field ranges are an *optimization*, not an answer: a field
// is only extracted when its value is an escape-free string, so -1/-1
// means "parse the metadata slice to find out", never "absent".  All
// offsets are byte positions into buf.  Returns 0 on success, -1 on
// any structural problem (caller falls back to a full json.loads).
int kfw_scan_event(const char* buf, int64_t len, int64_t* out) {
  if (buf == nullptr || out == nullptr || len < 0) {
    g_error = "bad arguments";
    return -1;
  }
  for (int i = 0; i < 12; ++i) out[i] = -1;
  Scan s(buf, len);
  const char *tvs = nullptr, *tve = nullptr;  // type content
  const char *ovs = nullptr, *ove = nullptr;  // object value
  // Single pass: the envelope iteration recurses member-aware into
  // "object" and from there into "metadata", so no byte is scanned
  // twice — the scan IS the per-event native cost.
  //
  // String-valued identity fields are extracted only when escape-free;
  // anything else stays -1/-1 and the Python side parses the metadata
  // slice on first touch (-1 means "go find out", never "absent").
  auto put_string = [&](int slot, const char* vs, const char* ve) {
    if (ve - vs < 2 || *vs != '"') return;
    const char* cs = vs + 1;
    const char* ce = ve - 1;
    if (std::memchr(cs, '\\', ce - cs) != nullptr) return;
    out[slot] = cs - buf;
    out[slot + 1] = ce - buf;
  };
  bool ok = s.object_members([&](const char* ks, const char* ke) -> bool {
    if (key_is(ks, ke, "type") && s.p < s.end && *s.p == '"') {
      const char *cs, *ce;
      if (!s.str(&cs, &ce)) return false;
      tvs = cs;
      tve = ce;
      return true;
    }
    if (key_is(ks, ke, "object")) {
      // Duplicate keys: json.loads keeps the LAST occurrence, so any
      // ranges recorded for an earlier "object"/"metadata" must be
      // dropped before scanning this one.
      for (int i = 4; i < 12; ++i) out[i] = -1;
      ovs = s.p;
      if (s.p < s.end && *s.p == '{') {
        bool iok = s.object_members([&](const char* ks2,
                                        const char* ke2) -> bool {
          if (key_is(ks2, ke2, "metadata")) {
            for (int i = 4; i < 12; ++i) out[i] = -1;
          }
          // Only an object-typed metadata is fast-pathable; a scalar
          // here (never produced by a real apiserver) stays
          // un-extracted so the Python side materializes the body and
          // sees the same value a full json.loads would.
          if (key_is(ks2, ke2, "metadata") && s.p < s.end && *s.p == '{') {
            const char* mvs = s.p;
            bool mok = s.object_members([&](const char* ks3,
                                            const char* ke3) -> bool {
              const char* vvs = s.p;
              if (!s.value()) return false;
              if (key_is(ks3, ke3, "name")) {
                out[6] = out[7] = -1;  // dup key: last wins
                put_string(6, vvs, s.p);
              } else if (key_is(ks3, ke3, "namespace")) {
                out[8] = out[9] = -1;
                put_string(8, vvs, s.p);
              } else if (key_is(ks3, ke3, "resourceVersion")) {
                out[10] = out[11] = -1;
                put_string(10, vvs, s.p);
              }
              return true;
            });
            if (!mok) return false;
            out[4] = mvs - buf;
            out[5] = s.p - buf;
            return true;
          }
          return s.value();
        });
        if (!iok) return false;
      } else if (!s.value()) {
        return false;  // ERROR events may carry a Status or scalar
      }
      ove = s.p;
      return true;
    }
    return s.value();
  });
  if (!ok) {
    g_error = s.err ? s.err : "scan failed";
    return -1;
  }
  s.ws();
  if (s.p != s.end) {
    g_error = "trailing data after envelope";
    return -1;
  }
  if (tvs == nullptr) {
    g_error = "missing or non-string 'type'";
    return -1;
  }
  if (ovs == nullptr) {
    g_error = "missing 'object'";
    return -1;
  }
  out[0] = tvs - buf;
  out[1] = tve - buf;
  out[2] = ovs - buf;
  out[3] = ove - buf;
  return 0;
}

}  // extern "C"
