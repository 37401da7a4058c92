// kfnative: native control-plane hot paths for the kubeflow_tpu_torch platform.
//
// Two subsystems, one shared library (libkft_native.so, built by platform/native.py):
//
//   kfp_*  — JSON parse/serialize + RFC 6902 patch create/apply.  This is the
//            admission-webhook hot path: every pod created in a profile
//            namespace is diffed (pod-before vs pod-after PodDefault merge)
//            into a JSONPatch for the AdmissionReview response.  Semantics
//            mirror kubeflow_tpu_torch/platform/webhook/jsonpatch.py exactly (the
//            reference webhook computes the same patch with a Go library,
//            reference admission-webhook/main.go:683-695).
//
//   kfq_*  — delaying, rate-limited, deduplicating workqueue (see workqueue.cc)
//            mirroring kubeflow_tpu_torch/platform/runtime/controller.py::_WorkQueue
//            (the reference's controller-runtime workqueue is Go,
//            client-go util/workqueue).
//
// The port's copy of the reference's native/jsonpatch.cc, with one change:
// a double serializes as Python's repr writes it (repr_double), where the
// reference's writes the shortest %g form (30.0 as 3e+01), so the canonical
// form is byte-equal to json.dumps for floats too.
//
// C API only (loaded via ctypes — pybind11 is not available in this image).
// Returned strings are heap-allocated; callers free with kfp_free().

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstdint>
#include <cstring>
#include <memory>
#include <string>
#include <utility>
#include <vector>

namespace kf {

// ---------------------------------------------------------------------------
// JSON value model.  Objects preserve insertion order (patch output ordering
// matches the Python implementation, which iterates dicts in insertion order).
// ---------------------------------------------------------------------------

struct Value;
using ValuePtr = std::shared_ptr<Value>;

// Big: an integer outside int64 range, kept as its source token so values
// like 2**63+1 round-trip exactly (Python ints are arbitrary precision; the
// diff must see them change).
enum class Kind : uint8_t { Null, Bool, Int, Double, Str, Arr, Obj, Big };

struct Value {
  Kind kind = Kind::Null;
  bool b = false;
  int64_t i = 0;
  double d = 0;
  std::string s;
  std::vector<ValuePtr> arr;
  std::vector<std::pair<std::string, ValuePtr>> obj;

  static ValuePtr null() { return std::make_shared<Value>(); }
  static ValuePtr boolean(bool v) {
    auto p = std::make_shared<Value>();
    p->kind = Kind::Bool;
    p->b = v;
    return p;
  }
  static ValuePtr integer(int64_t v) {
    auto p = std::make_shared<Value>();
    p->kind = Kind::Int;
    p->i = v;
    return p;
  }
  static ValuePtr real(double v) {
    auto p = std::make_shared<Value>();
    p->kind = Kind::Double;
    p->d = v;
    return p;
  }
  static ValuePtr str(std::string v) {
    auto p = std::make_shared<Value>();
    p->kind = Kind::Str;
    p->s = std::move(v);
    return p;
  }
  static ValuePtr big(std::string tok) {
    auto p = std::make_shared<Value>();
    p->kind = Kind::Big;
    p->s = std::move(tok);
    return p;
  }
  static ValuePtr array() {
    auto p = std::make_shared<Value>();
    p->kind = Kind::Arr;
    return p;
  }
  static ValuePtr object() {
    auto p = std::make_shared<Value>();
    p->kind = Kind::Obj;
    return p;
  }

  ValuePtr* find(const std::string& key) {
    for (auto& kv : obj)
      if (kv.first == key) return &kv.second;
    return nullptr;
  }
  void set(const std::string& key, ValuePtr v) {
    if (auto* p = find(key)) {
      *p = std::move(v);
      return;
    }
    obj.emplace_back(key, std::move(v));
  }
  bool erase(const std::string& key) {
    for (auto it = obj.begin(); it != obj.end(); ++it)
      if (it->first == key) {
        obj.erase(it);
        return true;
      }
    return false;
  }
};

// Deep *value* equality with Python == semantics: bools are numeric
// (True == 1), int/float compare numerically, big ints compare by token
// against int64 and numerically against doubles.  This is the comparison
// the Python diff performs via `before[key] != after[key]`, so the native
// and Python engines emit identical patches (tests/test_torch_native.py).
static bool equal(const Value& a, const Value& b) {
  if (a.kind != b.kind) {
    if (a.kind == Kind::Big || b.kind == Kind::Big) {
      const Value& big = a.kind == Kind::Big ? a : b;
      const Value& other = a.kind == Kind::Big ? b : a;
      if (other.kind == Kind::Int) return std::to_string(other.i) == big.s;
      if (other.kind == Kind::Double)
        return std::strtod(big.s.c_str(), nullptr) == other.d;
      if (other.kind == Kind::Bool) return false;  // magnitude rules it out
      return false;
    }
    auto num = [](const Value& v, double* out) {
      if (v.kind == Kind::Int) {
        *out = static_cast<double>(v.i);
        return true;
      }
      if (v.kind == Kind::Double) {
        *out = v.d;
        return true;
      }
      if (v.kind == Kind::Bool) {
        *out = v.b ? 1.0 : 0.0;
        return true;
      }
      return false;
    };
    double x, y;
    if (num(a, &x) && num(b, &y)) return x == y;
    return false;
  }
  switch (a.kind) {
    case Kind::Big:
      return a.s == b.s;
    case Kind::Null:
      return true;
    case Kind::Bool:
      return a.b == b.b;
    case Kind::Int:
      return a.i == b.i;
    case Kind::Double:
      return a.d == b.d;
    case Kind::Str:
      return a.s == b.s;
    case Kind::Arr: {
      if (a.arr.size() != b.arr.size()) return false;
      for (size_t k = 0; k < a.arr.size(); ++k)
        if (!equal(*a.arr[k], *b.arr[k])) return false;
      return true;
    }
    case Kind::Obj: {
      if (a.obj.size() != b.obj.size()) return false;
      // Key order does not affect equality.
      for (auto& kv : a.obj) {
        bool found = false;
        for (auto& kv2 : b.obj)
          if (kv2.first == kv.first) {
            if (!equal(*kv.second, *kv2.second)) return false;
            found = true;
            break;
          }
        if (!found) return false;
      }
      return true;
    }
  }
  return false;
}

static ValuePtr deep_copy(const Value& v) {
  auto p = std::make_shared<Value>();
  p->kind = v.kind;
  p->b = v.b;
  p->i = v.i;
  p->d = v.d;
  p->s = v.s;
  for (auto& e : v.arr) p->arr.push_back(deep_copy(*e));
  for (auto& kv : v.obj) p->obj.emplace_back(kv.first, deep_copy(*kv.second));
  return p;
}

// ---------------------------------------------------------------------------
// Parser (strict JSON, UTF-8 passthrough).
// ---------------------------------------------------------------------------

struct ParseError {
  std::string msg;
};

class Parser {
 public:
  explicit Parser(const char* text) : p_(text) {}

  ValuePtr parse() {
    skip_ws();
    ValuePtr v = parse_value();
    skip_ws();
    if (*p_ != '\0') throw ParseError{"trailing characters"};
    return v;
  }

 private:
  const char* p_;

  void skip_ws() {
    while (*p_ == ' ' || *p_ == '\t' || *p_ == '\n' || *p_ == '\r') ++p_;
  }

  [[noreturn]] void fail(const std::string& what) { throw ParseError{what}; }

  bool consume(const char* lit) {
    size_t n = std::strlen(lit);
    if (std::strncmp(p_, lit, n) == 0) {
      p_ += n;
      return true;
    }
    return false;
  }

  ValuePtr parse_value() {
    switch (*p_) {
      case 'n':
        if (consume("null")) return Value::null();
        fail("bad literal");
      case 't':
        if (consume("true")) return Value::boolean(true);
        fail("bad literal");
      case 'f':
        if (consume("false")) return Value::boolean(false);
        fail("bad literal");
      case '"':
        return Value::str(parse_string());
      case '[':
        return parse_array();
      case '{':
        return parse_object();
      default:
        return parse_number();
    }
  }

  std::string parse_string() {
    if (*p_ != '"') fail("expected string");
    ++p_;
    std::string out;
    while (*p_ != '"') {
      if (*p_ == '\0') fail("unterminated string");
      if (*p_ == '\\') {
        ++p_;
        switch (*p_) {
          case '"': out += '"'; break;
          case '\\': out += '\\'; break;
          case '/': out += '/'; break;
          case 'b': out += '\b'; break;
          case 'f': out += '\f'; break;
          case 'n': out += '\n'; break;
          case 'r': out += '\r'; break;
          case 't': out += '\t'; break;
          case 'u': {
            unsigned cp = 0;
            for (int k = 0; k < 4; ++k) {
              ++p_;
              char c = *p_;
              cp <<= 4;
              if (c >= '0' && c <= '9')
                cp |= c - '0';
              else if (c >= 'a' && c <= 'f')
                cp |= c - 'a' + 10;
              else if (c >= 'A' && c <= 'F')
                cp |= c - 'A' + 10;
              else
                fail("bad \\u escape");
            }
            // Surrogate pair?
            if (cp >= 0xD800 && cp <= 0xDBFF && p_[1] == '\\' && p_[2] == 'u') {
              unsigned lo = 0;
              const char* q = p_ + 3;
              for (int k = 0; k < 4; ++k) {
                char c = q[k];
                lo <<= 4;
                if (c >= '0' && c <= '9')
                  lo |= c - '0';
                else if (c >= 'a' && c <= 'f')
                  lo |= c - 'a' + 10;
                else if (c >= 'A' && c <= 'F')
                  lo |= c - 'A' + 10;
                else
                  fail("bad \\u escape");
              }
              if (lo >= 0xDC00 && lo <= 0xDFFF) {
                cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
                p_ = q + 3;  // past the 4 hex digits (loop ++ consumes last)
              }
            }
            // Encode UTF-8.
            if (cp < 0x80) {
              out += static_cast<char>(cp);
            } else if (cp < 0x800) {
              out += static_cast<char>(0xC0 | (cp >> 6));
              out += static_cast<char>(0x80 | (cp & 0x3F));
            } else if (cp < 0x10000) {
              out += static_cast<char>(0xE0 | (cp >> 12));
              out += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
              out += static_cast<char>(0x80 | (cp & 0x3F));
            } else {
              out += static_cast<char>(0xF0 | (cp >> 18));
              out += static_cast<char>(0x80 | ((cp >> 12) & 0x3F));
              out += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
              out += static_cast<char>(0x80 | (cp & 0x3F));
            }
            break;
          }
          default:
            fail("bad escape");
        }
        ++p_;
      } else {
        out += *p_++;
      }
    }
    ++p_;
    return out;
  }

  ValuePtr parse_number() {
    const char* start = p_;
    if (*p_ == '-') ++p_;
    while (*p_ >= '0' && *p_ <= '9') ++p_;
    bool is_double = false;
    if (*p_ == '.') {
      is_double = true;
      ++p_;
      while (*p_ >= '0' && *p_ <= '9') ++p_;
    }
    if (*p_ == 'e' || *p_ == 'E') {
      is_double = true;
      ++p_;
      if (*p_ == '+' || *p_ == '-') ++p_;
      while (*p_ >= '0' && *p_ <= '9') ++p_;
    }
    if (p_ == start || (p_ == start + 1 && *start == '-')) fail("bad number");
    std::string tok(start, p_);
    if (!is_double) {
      errno = 0;
      char* end = nullptr;
      long long v = std::strtoll(tok.c_str(), &end, 10);
      if (errno == 0 && end && *end == '\0') return Value::integer(v);
      return Value::big(tok);  // out-of-int64-range integer: keep the token
    }
    return Value::real(std::strtod(tok.c_str(), nullptr));
  }

  ValuePtr parse_array() {
    ++p_;  // [
    auto v = Value::array();
    skip_ws();
    if (*p_ == ']') {
      ++p_;
      return v;
    }
    while (true) {
      skip_ws();
      v->arr.push_back(parse_value());
      skip_ws();
      if (*p_ == ',') {
        ++p_;
        continue;
      }
      if (*p_ == ']') {
        ++p_;
        return v;
      }
      fail("expected , or ] in array");
    }
  }

  ValuePtr parse_object() {
    ++p_;  // {
    auto v = Value::object();
    skip_ws();
    if (*p_ == '}') {
      ++p_;
      return v;
    }
    while (true) {
      skip_ws();
      std::string key = parse_string();
      skip_ws();
      if (*p_ != ':') fail("expected : in object");
      ++p_;
      skip_ws();
      v->set(key, parse_value());
      skip_ws();
      if (*p_ == ',') {
        ++p_;
        continue;
      }
      if (*p_ == '}') {
        ++p_;
        return v;
      }
      fail("expected , or } in object");
    }
  }
};

// ---------------------------------------------------------------------------
// Serializer (compact; separators match Python json.dumps(..., separators=(",", ":"))
// so round-trips are byte-comparable in tests).
// ---------------------------------------------------------------------------


// A finite double as Python's repr writes it (the form json.dumps uses):
// the shortest digits that round-trip, fixed notation for decimal
// exponents in [-4, 16) with at least one digit after the point, else
// d[.ddd]e+XX with a two-digit exponent at least.
static std::string repr_double(double d) {
  char buf[40];
  for (int prec = 1; prec <= 17; ++prec) {
    snprintf(buf, sizeof(buf), "%.*e", prec - 1, d);
    if (std::strtod(buf, nullptr) == d) break;
  }
  std::string text(buf);
  std::string sign;
  if (!text.empty() && text[0] == '-') {
    sign = "-";
    text.erase(0, 1);
  }
  size_t epos = text.find('e');
  int exp = std::atoi(text.c_str() + epos + 1);
  std::string digits;
  for (size_t i = 0; i < epos; ++i) {
    if (text[i] != '.') digits += text[i];
  }
  while (digits.size() > 1 && digits.back() == '0') digits.pop_back();
  std::string out = sign;
  if (exp >= -4 && exp < 16) {
    if (exp >= 0) {
      if (digits.size() <= static_cast<size_t>(exp) + 1) {
        out += digits + std::string(exp + 1 - digits.size(), '0') + ".0";
      } else {
        out += digits.substr(0, exp + 1) + "." + digits.substr(exp + 1);
      }
    } else {
      out += "0." + std::string(-exp - 1, '0') + digits;
    }
  } else {
    out += digits.substr(0, 1);
    if (digits.size() > 1) out += "." + digits.substr(1);
    char ebuf[8];
    snprintf(ebuf, sizeof(ebuf), "e%c%02d", exp < 0 ? '-' : '+',
             exp < 0 ? -exp : exp);
    out += ebuf;
  }
  return out;
}

static void serialize(const Value& v, std::string& out) {
  switch (v.kind) {
    case Kind::Null:
      out += "null";
      break;
    case Kind::Bool:
      out += v.b ? "true" : "false";
      break;
    case Kind::Int: {
      out += std::to_string(v.i);
      break;
    }
    case Kind::Big: {
      out += v.s;
      break;
    }
    case Kind::Double: {
      if (std::isfinite(v.d)) {
        out += repr_double(v.d);
      } else {
        out += "null";  // JSON has no NaN/Inf
      }
      break;
    }
    case Kind::Str: {
      out += '"';
      for (unsigned char c : v.s) {
        switch (c) {
          case '"': out += "\\\""; break;
          case '\\': out += "\\\\"; break;
          case '\b': out += "\\b"; break;
          case '\f': out += "\\f"; break;
          case '\n': out += "\\n"; break;
          case '\r': out += "\\r"; break;
          case '\t': out += "\\t"; break;
          default:
            if (c < 0x20) {
              char buf[8];
              snprintf(buf, sizeof(buf), "\\u%04x", c);
              out += buf;
            } else {
              out += static_cast<char>(c);  // UTF-8 passthrough
            }
        }
      }
      out += '"';
      break;
    }
    case Kind::Arr: {
      out += '[';
      for (size_t k = 0; k < v.arr.size(); ++k) {
        if (k) out += ',';
        serialize(*v.arr[k], out);
      }
      out += ']';
      break;
    }
    case Kind::Obj: {
      out += '{';
      bool first = true;
      for (auto& kv : v.obj) {
        if (!first) out += ',';
        first = false;
        serialize(*Value::str(kv.first), out);
        out += ':';
        serialize(*kv.second, out);
      }
      out += '}';
      break;
    }
  }
}

// ---------------------------------------------------------------------------
// RFC 6901 pointers + RFC 6902 create_patch / apply_patch.
// ---------------------------------------------------------------------------

static std::string escape_token(const std::string& t) {
  std::string out;
  for (char c : t) {
    if (c == '~')
      out += "~0";
    else if (c == '/')
      out += "~1";
    else
      out += c;
  }
  return out;
}

static std::string unescape_token(const std::string& t) {
  std::string out;
  for (size_t k = 0; k < t.size(); ++k) {
    if (t[k] == '~' && k + 1 < t.size() && t[k + 1] == '1') {
      out += '/';
      ++k;
    } else if (t[k] == '~' && k + 1 < t.size() && t[k + 1] == '0') {
      out += '~';
      ++k;
    } else {
      out += t[k];
    }
  }
  return out;
}

struct PatchError {
  std::string msg;
};

static std::vector<std::string> split_pointer(const std::string& ptr) {
  if (ptr.empty() || ptr[0] != '/') throw PatchError{"invalid pointer " + ptr};
  std::vector<std::string> out;
  size_t start = 1;
  for (size_t k = 1; k <= ptr.size(); ++k) {
    if (k == ptr.size() || ptr[k] == '/') {
      out.push_back(unescape_token(ptr.substr(start, k - start)));
      start = k + 1;
    }
  }
  return out;
}

static long array_index(const std::string& tok) {
  if (tok.empty()) throw PatchError{"bad array index"};
  for (char c : tok)
    if (c < '0' || c > '9') {
      if (!(c == '-' && tok.size() > 1)) throw PatchError{"bad array index " + tok};
    }
  return std::strtol(tok.c_str(), nullptr, 10);
}

// Returns the parent container of the pointer target + last token.
static std::pair<ValuePtr, std::string> walk(ValuePtr doc, const std::string& ptr,
                                             bool create) {
  auto tokens = split_pointer(ptr);
  ValuePtr cur = doc;
  for (size_t k = 0; k + 1 < tokens.size(); ++k) {
    const std::string& tok = tokens[k];
    if (cur->kind == Kind::Arr) {
      long idx = array_index(tok);
      if (idx < 0 || static_cast<size_t>(idx) >= cur->arr.size())
        throw PatchError{"index out of range in " + ptr};
      cur = cur->arr[idx];
    } else if (cur->kind == Kind::Obj) {
      ValuePtr* next = cur->find(tok);
      if (!next && create) {
        cur->set(tok, Value::object());
        next = cur->find(tok);
      }
      if (!next) throw PatchError{"path " + ptr + ": missing " + tok};
      cur = *next;
    } else {
      throw PatchError{"path " + ptr + ": cannot traverse scalar"};
    }
  }
  return {cur, tokens.back()};
}

static ValuePtr pointer_get(ValuePtr doc, const std::string& ptr) {
  auto [parent, last] = walk(doc, ptr, false);
  if (parent->kind == Kind::Arr) {
    long idx = array_index(last);
    if (idx < 0 || static_cast<size_t>(idx) >= parent->arr.size())
      throw PatchError{"index out of range in " + ptr};
    return parent->arr[idx];
  }
  if (ValuePtr* p = parent->find(last)) return *p;
  return Value::null();
}

static void pointer_add(ValuePtr doc, const std::string& ptr, ValuePtr val) {
  auto [parent, last] = walk(doc, ptr, true);
  if (parent->kind == Kind::Arr) {
    if (last == "-") {
      parent->arr.push_back(std::move(val));
    } else {
      long idx = array_index(last);
      if (idx < 0 || static_cast<size_t>(idx) > parent->arr.size())
        throw PatchError{"index out of range in " + ptr};
      parent->arr.insert(parent->arr.begin() + idx, std::move(val));
    }
  } else if (parent->kind == Kind::Obj) {
    parent->set(last, std::move(val));
  } else {
    throw PatchError{"add into scalar at " + ptr};
  }
}

static ValuePtr apply_patch(ValuePtr doc, const Value& ops) {
  if (ops.kind != Kind::Arr) throw PatchError{"patch must be an array"};
  doc = deep_copy(*doc);
  for (auto& opv : ops.arr) {
    Value& op = *opv;
    if (op.kind != Kind::Obj) throw PatchError{"op must be an object"};
    ValuePtr* kindp = op.find("op");
    if (!kindp || (*kindp)->kind != Kind::Str) throw PatchError{"missing op"};
    const std::string& kind = (*kindp)->s;
    std::string path;
    if (ValuePtr* p = op.find("path")) path = (*p)->s;

    if ((kind == "add" || kind == "replace") && path.empty()) {
      ValuePtr* v = op.find("value");
      if (!v) throw PatchError{"missing value"};
      doc = deep_copy(**v);
      continue;
    }
    if (kind == "add") {
      ValuePtr* v = op.find("value");
      if (!v) throw PatchError{"missing value"};
      pointer_add(doc, path, deep_copy(**v));
    } else if (kind == "replace") {
      ValuePtr* v = op.find("value");
      if (!v) throw PatchError{"missing value"};
      auto [parent, last] = walk(doc, path, false);
      if (parent->kind == Kind::Arr) {
        long idx = array_index(last);
        if (idx < 0 || static_cast<size_t>(idx) >= parent->arr.size())
          throw PatchError{"index out of range in " + path};
        parent->arr[idx] = deep_copy(**v);
      } else {
        if (!parent->find(last)) throw PatchError{"replace at missing path " + path};
        parent->set(last, deep_copy(**v));
      }
    } else if (kind == "remove") {
      auto [parent, last] = walk(doc, path, false);
      if (parent->kind == Kind::Arr) {
        long idx = array_index(last);
        if (idx < 0 || static_cast<size_t>(idx) >= parent->arr.size())
          throw PatchError{"index out of range in " + path};
        parent->arr.erase(parent->arr.begin() + idx);
      } else {
        if (!parent->erase(last)) throw PatchError{"remove at missing path " + path};
      }
    } else if (kind == "test") {
      ValuePtr cur = pointer_get(doc, path);
      ValuePtr* v = op.find("value");
      ValuePtr expect = v ? *v : Value::null();
      if (!equal(*cur, *expect)) throw PatchError{"test failed at " + path};
    } else if (kind == "move" || kind == "copy") {
      ValuePtr* fromp = op.find("from");
      if (!fromp) throw PatchError{"missing from"};
      const std::string& from = (*fromp)->s;
      ValuePtr val = deep_copy(*pointer_get(doc, from));
      if (kind == "move") {
        auto [sp, sl] = walk(doc, from, false);
        if (sp->kind == Kind::Arr) {
          long idx = array_index(sl);
          sp->arr.erase(sp->arr.begin() + idx);
        } else {
          sp->erase(sl);
        }
      }
      pointer_add(doc, path, std::move(val));
    } else {
      throw PatchError{"unknown op " + kind};
    }
  }
  return doc;
}

// Distinct-type check for the diff, mirroring Python's `type(b) is not
// type(a)`: bool vs int differ, int vs float differ, but Int and Big are
// both Python ints.
static bool same_kind(const Value& a, const Value& b) {
  if (a.kind == b.kind) return true;
  auto is_int = [](const Value& v) {
    return v.kind == Kind::Int || v.kind == Kind::Big;
  };
  return is_int(a) && is_int(b);
}

static void create_patch(const Value& before, const Value& after,
                         const std::string& path, ValuePtr out) {
  if (!same_kind(before, after)) {
    auto op = Value::object();
    op->set("op", Value::str("replace"));
    op->set("path", Value::str(path));
    op->set("value", deep_copy(after));
    out->arr.push_back(op);
    return;
  }
  if (before.kind == Kind::Obj) {
    for (auto& kv : before.obj) {
      std::string sub = path + "/" + escape_token(kv.first);
      auto it = const_cast<Value&>(after).find(kv.first);
      if (!it) {
        auto op = Value::object();
        op->set("op", Value::str("remove"));
        op->set("path", Value::str(sub));
        out->arr.push_back(op);
      } else if (!equal(*kv.second, **it)) {
        create_patch(*kv.second, **it, sub, out);
      }
    }
    for (auto& kv : after.obj) {
      if (!const_cast<Value&>(before).find(kv.first)) {
        auto op = Value::object();
        op->set("op", Value::str("add"));
        op->set("path", Value::str(path + "/" + escape_token(kv.first)));
        op->set("value", deep_copy(*kv.second));
        out->arr.push_back(op);
      }
    }
    return;
  }
  if (!equal(before, after)) {
    auto op = Value::object();
    op->set("op", Value::str("replace"));
    op->set("path", Value::str(path));
    op->set("value", deep_copy(after));
    out->arr.push_back(op);
  }
}

// ---------------------------------------------------------------------------
// RFC 7386 JSON merge patch (apply + create).  FakeKube.patch and the REST
// client's merge-patch path use this; semantics mirror
// kubeflow_tpu_torch/platform/testing/fake.py::_merge_patch.
// ---------------------------------------------------------------------------

static ValuePtr merge_patch_apply(const Value& target, const Value& patch) {
  if (patch.kind != Kind::Obj) return deep_copy(patch);
  ValuePtr result =
      target.kind == Kind::Obj ? deep_copy(target) : Value::object();
  for (const auto& kv : patch.obj) {
    if (kv.second->kind == Kind::Null) {
      result->erase(kv.first);
      continue;
    }
    ValuePtr* cur = result->find(kv.first);
    if (cur && (*cur)->kind == Kind::Obj && kv.second->kind == Kind::Obj) {
      result->set(kv.first, merge_patch_apply(**cur, *kv.second));
    } else {
      // RFC 7386: patching a non-object target applies the patch to {},
      // which also strips nulls nested inside the patch value.
      Value empty;
      result->set(kv.first, merge_patch_apply(empty, *kv.second));
    }
  }
  return result;
}

static ValuePtr merge_patch_create(const Value& before, const Value& after) {
  if (before.kind != Kind::Obj || after.kind != Kind::Obj)
    return deep_copy(after);
  auto patch = Value::object();
  for (const auto& kv : before.obj) {
    if (!const_cast<Value&>(after).find(kv.first))
      patch->set(kv.first, Value::null());
  }
  for (const auto& kv : after.obj) {
    ValuePtr* b = const_cast<Value&>(before).find(kv.first);
    if (!b) {
      patch->set(kv.first, deep_copy(*kv.second));
    } else if (!equal(**b, *kv.second)) {
      if ((*b)->kind == Kind::Obj && kv.second->kind == Kind::Obj)
        patch->set(kv.first, merge_patch_create(**b, *kv.second));
      else
        patch->set(kv.first, deep_copy(*kv.second));
    }
  }
  return patch;
}

}  // namespace kf

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------

static thread_local std::string g_error;

static const char* dup_out(const std::string& s) {
  char* out = static_cast<char*>(std::malloc(s.size() + 1));
  std::memcpy(out, s.c_str(), s.size() + 1);
  return out;
}

extern "C" {

const char* kfp_last_error() { return g_error.c_str(); }

void kfp_free(const char* p) { std::free(const_cast<char*>(p)); }

// Diff two JSON documents → RFC 6902 patch (JSON array), or NULL on error.
const char* kfp_create_patch(const char* before, const char* after) {
  try {
    kf::ValuePtr b = kf::Parser(before).parse();
    kf::ValuePtr a = kf::Parser(after).parse();
    auto out = kf::Value::array();
    kf::create_patch(*b, *a, "", out);
    std::string s;
    kf::serialize(*out, s);
    return dup_out(s);
  } catch (const kf::ParseError& e) {
    g_error = "parse error: " + e.msg;
  } catch (const kf::PatchError& e) {
    g_error = e.msg;
  } catch (...) {
    g_error = "unknown error";
  }
  return nullptr;
}

// Apply an RFC 6902 patch to a document → patched JSON, or NULL on error.
const char* kfp_apply_patch(const char* doc, const char* patch) {
  try {
    kf::ValuePtr d = kf::Parser(doc).parse();
    kf::ValuePtr p = kf::Parser(patch).parse();
    kf::ValuePtr out = kf::apply_patch(d, *p);
    std::string s;
    kf::serialize(*out, s);
    return dup_out(s);
  } catch (const kf::ParseError& e) {
    g_error = "parse error: " + e.msg;
  } catch (const kf::PatchError& e) {
    g_error = e.msg;
  } catch (...) {
    g_error = "unknown error";
  }
  return nullptr;
}

// RFC 7386: apply a merge patch to a document → merged JSON, or NULL.
const char* kfp_merge_apply(const char* doc, const char* patch) {
  try {
    kf::ValuePtr d = kf::Parser(doc).parse();
    kf::ValuePtr p = kf::Parser(patch).parse();
    kf::ValuePtr out = kf::merge_patch_apply(*d, *p);
    std::string s;
    kf::serialize(*out, s);
    return dup_out(s);
  } catch (const kf::ParseError& e) {
    g_error = "parse error: " + e.msg;
  } catch (...) {
    g_error = "unknown error";
  }
  return nullptr;
}

// RFC 7386: diff two documents → the merge patch turning before into after.
const char* kfp_merge_create(const char* before, const char* after) {
  try {
    kf::ValuePtr b = kf::Parser(before).parse();
    kf::ValuePtr a = kf::Parser(after).parse();
    kf::ValuePtr out = kf::merge_patch_create(*b, *a);
    std::string s;
    kf::serialize(*out, s);
    return dup_out(s);
  } catch (const kf::ParseError& e) {
    g_error = "parse error: " + e.msg;
  } catch (...) {
    g_error = "unknown error";
  }
  return nullptr;
}

// Round-trip canonicalization (parse + compact serialize); used by tests.
const char* kfp_canonical(const char* doc) {
  try {
    kf::ValuePtr d = kf::Parser(doc).parse();
    std::string s;
    kf::serialize(*d, s);
    return dup_out(s);
  } catch (const kf::ParseError& e) {
    g_error = "parse error: " + e.msg;
    return nullptr;
  }
}

}  // extern "C"
