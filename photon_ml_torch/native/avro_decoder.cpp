// Columnar Avro container decoder — the native ingestion fast path (the
// port's copy of the JAX package's decoder, built by photon_ml_torch/build.py).
//
// Replaces the per-record Python decode of io/avro.py for the training-data
// hot path (the reference's ingestion is JVM-compiled Avro + Spark;
// photon-client data/avro/AvroDataReader.scala): one pass over each
// container block executing a PLAN compiled from the schema by
// io/avro_native.py, emitting columns:
//   numeric fields  -> double columns (NaN for null branches)
//   string fields   -> interned id columns + a string table
//   feature bags    -> (row, key_id, value) triples + an interned
//                      "name\x01term" key table
//   string maps     -> (row, key_id, value_id) triples + two tables
// Strings are interned HERE so Python never materializes per-entry
// strings — only the (small) unique tables cross the boundary.
//
// The plan is a prefix-serialized op tree (see io/avro_native.py for the
// compiler and the Python-side contract). Unsupported schema shapes never
// reach this file: the compiler refuses and callers fall back to the
// pure-Python reader.

#include <algorithm>
#include <cstdint>
#include <limits>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include <zlib.h>

namespace {

enum Op : int64_t {
  OP_RECORD = 1,
  OP_UNION = 2,
  OP_ARRAY = 3,
  OP_MAP = 4,
  OP_NULL = 5,
  OP_BOOL = 6,
  OP_INT = 7,
  OP_LONG = 8,
  OP_FLOAT = 9,
  OP_DOUBLE = 10,
  OP_STRING = 11,
  OP_BYTES = 12,
  OP_FIXED = 13,  // [op, size]
  OP_COL_DOUBLE = 20,  // [op, slot]
  OP_COL_FLOAT = 21,
  OP_COL_INT = 22,
  OP_COL_LONG = 23,
  OP_COL_BOOL = 24,
  OP_COL_NULLNUM = 25,
  OP_COL_STR = 26,
  OP_COL_NULLSTR = 27,
  OP_MAP_COLLECT = 28,  // [op, slot, value_child]
  OP_MAPVAL_STR = 29,
  OP_MAPVAL_NULL = 30,
  OP_BAG = 31,  // [op, slot, item_child]
  OP_BAG_NAME = 32,
  OP_BAG_TERM = 33,
  OP_BAG_TERM_NULL = 34,
  OP_BAG_VALUE = 35,  // [op, kind] kind: 0=double 1=float 2=int/long 3=bool
  OP_COL_STRNUM = 36,   // [op, slot] string parsed as double (NaN if not)
  OP_COL_LONGSTR = 37,  // [op, slot] long rendered as decimal -> strcol
  OP_COL_BOOLSTR = 38,  // [op, slot] bool -> "True"/"False" -> strcol
  OP_MAPVAL_LONGSTR = 39,
  OP_MAPVAL_BOOLSTR = 40,
  OP_MAPVAL_BAD = 41,  // runtime value we cannot render faithfully
};

constexpr uint32_t NULL_ID = 0xFFFFFFFFu;

struct Pool {
  std::unordered_map<std::string, uint32_t> ids;
  std::string blob;
  std::vector<uint64_t> offsets{0};

  uint32_t intern(const char* s, size_t len) {
    std::string key(s, len);
    auto it = ids.find(key);
    if (it != ids.end()) return it->second;
    uint32_t id = static_cast<uint32_t>(ids.size());
    ids.emplace(std::move(key), id);
    blob.append(s, len);
    offsets.push_back(blob.size());
    return id;
  }
};

struct BagOut {
  std::vector<uint32_t> rows;
  std::vector<uint32_t> keys;
  std::vector<double> vals;
  Pool pool;
};

struct MapOut {
  std::vector<uint32_t> rows;
  std::vector<uint32_t> keys;
  std::vector<uint32_t> valids;
  Pool kpool;
  Pool vpool;
};

struct Decoder {
  const uint8_t* p;
  const uint8_t* end;
  bool fail = false;

  int64_t read_long() {
    uint64_t acc = 0;
    int shift = 0;
    while (p < end) {
      uint8_t b = *p++;
      acc |= static_cast<uint64_t>(b & 0x7F) << shift;
      if (!(b & 0x80)) {
        return static_cast<int64_t>(acc >> 1) ^ -static_cast<int64_t>(acc & 1);
      }
      shift += 7;
      if (shift > 63) break;
    }
    fail = true;
    return 0;
  }
  double read_double() {
    if (end - p < 8) { fail = true; return 0.0; }
    double v;
    std::memcpy(&v, p, 8);
    p += 8;
    return v;
  }
  float read_float() {
    if (end - p < 4) { fail = true; return 0.0f; }
    float v;
    std::memcpy(&v, p, 4);
    p += 4;
    return v;
  }
  const char* read_bytes(int64_t* len) {
    *len = read_long();
    if (fail || *len < 0 || end - p < *len) { fail = true; return nullptr; }
    const char* s = reinterpret_cast<const char*>(p);
    p += *len;
    return s;
  }
  void skip(int64_t n) {
    if (end - p < n) { fail = true; return; }
    p += n;
  }
};

struct State {
  std::vector<std::vector<double>> numcols;
  std::vector<std::vector<uint8_t>> numnulls;  // 1 where the null branch fired
  std::vector<std::vector<uint32_t>> strcols;
  std::vector<Pool> strpools;
  std::vector<BagOut> bags;
  std::vector<MapOut> maps;
  uint32_t row = 0;
  // per-item bag registers (key carries "name\x01term" via the splice
  // logic in OP_BAG_NAME / OP_BAG_TERM)
  std::string bag_key;
  double bag_value = 0.0;
};

// Advance `i` past the node at plan[i] without executing (plan traversal).
void plan_skip(const int64_t* plan, size_t& i) {
  int64_t op = plan[i++];
  switch (op) {
    case OP_RECORD: case OP_UNION: {
      int64_t n = plan[i++];
      for (int64_t k = 0; k < n; ++k) plan_skip(plan, i);
      break;
    }
    case OP_ARRAY: case OP_MAP: case OP_MAP_COLLECT: case OP_BAG:
      if (op == OP_MAP_COLLECT || op == OP_BAG) i++;  // slot
      plan_skip(plan, i);
      break;
    case OP_FIXED: case OP_COL_DOUBLE: case OP_COL_FLOAT: case OP_COL_INT:
    case OP_COL_LONG: case OP_COL_BOOL: case OP_COL_NULLNUM:
    case OP_COL_STR: case OP_COL_NULLSTR: case OP_BAG_VALUE:
    case OP_COL_STRNUM: case OP_COL_LONGSTR: case OP_COL_BOOLSTR:
      i++;  // one param
      break;
    default:
      break;  // leaf with no params
  }
}

struct Exec {
  Decoder& d;
  State& st;
  const int64_t* plan;
  bool bad_plan = false;

  void run(size_t& i) {
    int64_t op = plan[i++];
    switch (op) {
      case OP_RECORD: {
        int64_t n = plan[i++];
        for (int64_t k = 0; k < n && !d.fail; ++k) run(i);
        break;
      }
      case OP_UNION: {
        int64_t n = plan[i++];
        int64_t branch = d.read_long();
        if (branch < 0 || branch >= n) { d.fail = true; branch = 0; }
        for (int64_t k = 0; k < n; ++k) {
          if (k == branch && !d.fail) run(i); else plan_skip(plan, i);
        }
        break;
      }
      case OP_ARRAY: {
        size_t child = i;
        plan_skip(plan, i);
        for (;;) {
          int64_t count = d.read_long();
          if (d.fail || count == 0) break;
          if (count < 0) { d.read_long(); count = -count; }  // block size
          for (int64_t k = 0; k < count && !d.fail; ++k) {
            size_t c = child;
            run(c);
          }
        }
        break;
      }
      case OP_MAP: {
        size_t child = i;
        plan_skip(plan, i);
        for (;;) {
          int64_t count = d.read_long();
          if (d.fail || count == 0) break;
          if (count < 0) { d.read_long(); count = -count; }
          for (int64_t k = 0; k < count && !d.fail; ++k) {
            int64_t len;
            d.read_bytes(&len);  // key
            size_t c = child;
            run(c);
          }
        }
        break;
      }
      case OP_NULL: break;
      case OP_BOOL: d.skip(1); break;
      case OP_INT: case OP_LONG: d.read_long(); break;
      case OP_FLOAT: d.skip(4); break;
      case OP_DOUBLE: d.skip(8); break;
      case OP_STRING: case OP_BYTES: {
        int64_t len;
        d.read_bytes(&len);
        break;
      }
      case OP_FIXED: d.skip(plan[i++]); break;
      case OP_COL_DOUBLE: {
        int64_t slot = plan[i++];
        st.numcols[slot].push_back(d.read_double());
        st.numnulls[slot].push_back(0);
        break;
      }
      case OP_COL_FLOAT: {
        int64_t slot = plan[i++];
        st.numcols[slot].push_back(d.read_float());
        st.numnulls[slot].push_back(0);
        break;
      }
      case OP_COL_INT: case OP_COL_LONG: {
        int64_t slot = plan[i++];
        st.numcols[slot].push_back(static_cast<double>(d.read_long()));
        st.numnulls[slot].push_back(0);
        break;
      }
      case OP_COL_BOOL: {
        double v = (d.p < d.end && *d.p) ? 1.0 : 0.0;
        d.skip(1);
        int64_t slot = plan[i++];
        st.numcols[slot].push_back(v);
        st.numnulls[slot].push_back(0);
        break;
      }
      case OP_COL_NULLNUM: {
        int64_t slot = plan[i++];
        st.numcols[slot].push_back(
            std::numeric_limits<double>::quiet_NaN());
        st.numnulls[slot].push_back(1);
        break;
      }
      case OP_COL_STR: {
        int64_t len;
        const char* s = d.read_bytes(&len);
        int64_t slot = plan[i++];
        if (!d.fail) st.strcols[slot].push_back(st.strpools[slot].intern(s, len));
        break;
      }
      case OP_COL_NULLSTR: st.strcols[plan[i++]].push_back(NULL_ID); break;
      case OP_COL_STRNUM: {
        int64_t len;
        const char* sp = d.read_bytes(&len);
        int64_t slot = plan[i++];
        if (!d.fail) {
          std::string tmp(sp, len);
          char* endp = nullptr;
          double v = std::strtod(tmp.c_str(), &endp);
          if (endp != tmp.c_str() + tmp.size() || tmp.empty())
            v = std::numeric_limits<double>::quiet_NaN();
          st.numcols[slot].push_back(v);
          st.numnulls[slot].push_back(0);
        }
        break;
      }
      case OP_COL_LONGSTR: {
        int64_t v = d.read_long();
        int64_t slot = plan[i++];
        if (!d.fail) {
          char buf[24];
          int blen = snprintf(buf, sizeof buf, "%lld",
                              static_cast<long long>(v));
          st.strcols[slot].push_back(st.strpools[slot].intern(buf, blen));
        }
        break;
      }
      case OP_COL_BOOLSTR: {
        bool v = (d.p < d.end && *d.p);
        d.skip(1);
        int64_t slot = plan[i++];
        if (!d.fail)
          st.strcols[slot].push_back(
              v ? st.strpools[slot].intern("True", 4)
                : st.strpools[slot].intern("False", 5));
        break;
      }
      case OP_MAP_COLLECT: {
        int64_t slot = plan[i++];
        size_t child = i;
        plan_skip(plan, i);
        MapOut& m = st.maps[slot];
        for (;;) {
          int64_t count = d.read_long();
          if (d.fail || count == 0) break;
          if (count < 0) { d.read_long(); count = -count; }
          for (int64_t k = 0; k < count && !d.fail; ++k) {
            int64_t klen;
            const char* ks = d.read_bytes(&klen);
            if (d.fail) break;
            uint32_t kid = m.kpool.intern(ks, klen);
            // value child: OP_MAPVAL_STR or a union over {STR, NULL}
            size_t c = child;
            uint32_t vid = run_mapval(c, m);
            if (d.fail) break;
            m.rows.push_back(st.row);
            m.keys.push_back(kid);
            m.valids.push_back(vid);
          }
        }
        break;
      }
      case OP_BAG: {
        int64_t slot = plan[i++];
        size_t child = i;
        plan_skip(plan, i);
        BagOut& b = st.bags[slot];
        for (;;) {
          int64_t count = d.read_long();
          if (d.fail || count == 0) break;
          if (count < 0) { d.read_long(); count = -count; }
          for (int64_t k = 0; k < count && !d.fail; ++k) {
            st.bag_key.clear();
            st.bag_value = 0.0;
            size_t c = child;
            run(c);
            if (d.fail) break;
            // key = name \x01 term (term absent/null -> empty)
            uint32_t kid = b.pool.intern(st.bag_key.data(), st.bag_key.size());
            b.rows.push_back(st.row);
            b.keys.push_back(kid);
            b.vals.push_back(st.bag_value);
          }
        }
        break;
      }
      case OP_BAG_NAME: {
        int64_t len;
        const char* s = d.read_bytes(&len);
        if (!d.fail) {
          // name goes first; term appended after the separator later
          std::string tail;
          size_t sep = st.bag_key.find('\x01');
          if (sep != std::string::npos) tail = st.bag_key.substr(sep);
          st.bag_key.assign(s, len);
          st.bag_key += tail.empty() ? std::string(1, '\x01') : tail;
        }
        break;
      }
      case OP_BAG_TERM: {
        int64_t len;
        const char* s = d.read_bytes(&len);
        if (!d.fail) {
          size_t sep = st.bag_key.find('\x01');
          if (sep == std::string::npos) {
            st.bag_key += '\x01';
            sep = st.bag_key.size() - 1;
          }
          st.bag_key.resize(sep + 1);
          st.bag_key.append(s, len);
        }
        break;
      }
      case OP_BAG_TERM_NULL:
        if (st.bag_key.find('\x01') == std::string::npos) st.bag_key += '\x01';
        break;
      case OP_BAG_VALUE: {
        int64_t kind = plan[i++];
        switch (kind) {
          case 0: st.bag_value = d.read_double(); break;
          case 1: st.bag_value = d.read_float(); break;
          case 2: st.bag_value = static_cast<double>(d.read_long()); break;
          case 3: {
            st.bag_value = (d.p < d.end && *d.p) ? 1.0 : 0.0;
            d.skip(1);
            break;
          }
          default: bad_plan = true;
        }
        break;
      }
      default:
        bad_plan = true;
        d.fail = true;
    }
  }

  uint32_t run_mapval(size_t& i, MapOut& m) {
    int64_t op = plan[i++];
    if (op == OP_MAPVAL_STR) {
      int64_t len;
      const char* s = d.read_bytes(&len);
      if (d.fail) return NULL_ID;
      return m.vpool.intern(s, len);
    }
    if (op == OP_MAPVAL_LONGSTR) {
      int64_t v = d.read_long();
      if (d.fail) return NULL_ID;
      char buf[24];
      int blen = snprintf(buf, sizeof buf, "%lld", static_cast<long long>(v));
      return m.vpool.intern(buf, blen);
    }
    if (op == OP_MAPVAL_BOOLSTR) {
      bool v = (d.p < d.end && *d.p);
      d.skip(1);
      if (d.fail) return NULL_ID;
      return v ? m.vpool.intern("True", 4) : m.vpool.intern("False", 5);
    }
    if (op == OP_MAPVAL_BAD) {
      // a runtime value (e.g. a double map entry) that Python's str() and
      // we cannot render identically — force the caller's fallback
      bad_plan = true;
      d.fail = true;
      return NULL_ID;
    }
    if (op == OP_UNION) {
      int64_t n = plan[i++];
      int64_t branch = d.read_long();
      if (branch < 0 || branch >= n) { d.fail = true; return NULL_ID; }
      uint32_t out = NULL_ID;
      for (int64_t k = 0; k < n; ++k) {
        if (k == branch) {
          int64_t sub = plan[i];
          if (sub == OP_MAPVAL_NULL) {
            i++;
          } else {
            out = run_mapval(i, m);
          }
        } else {
          size_t j = i;
          // mapval nodes are leaves
          i = j + 1;
        }
      }
      return out;
    }
    if (op == OP_MAPVAL_NULL) return NULL_ID;
    bad_plan = true;
    d.fail = true;
    return NULL_ID;
  }
};

struct Handle {
  State st;
  int64_t n_records = 0;
  // stable views for ctypes accessors
  std::vector<std::vector<uint64_t>> bag_offs;
  std::vector<std::vector<uint64_t>> str_offs;
  std::vector<std::vector<uint64_t>> mapk_offs;
  std::vector<std::vector<uint64_t>> mapv_offs;
};

// zigzag varint straight off the FILE stream (header + block framing; the
// in-block decoder has its own pointer-based reader)
int64_t file_varint(FILE* f, bool* ok) {
  uint64_t acc = 0;
  int shift = 0;
  int c;
  while ((c = std::fgetc(f)) != EOF) {
    acc |= static_cast<uint64_t>(c & 0x7F) << shift;
    if (!(c & 0x80))
      return static_cast<int64_t>(acc >> 1) ^ -static_cast<int64_t>(acc & 1);
    shift += 7;
    if (shift > 63) break;  // malformed varint; shifting past 64 is UB
  }
  *ok = false;
  return 0;
}

bool read_header(FILE* f, std::string* codec, uint8_t sync[16], char* err,
                 size_t errlen) {
  uint8_t magic[4];
  if (std::fread(magic, 1, 4, f) != 4 || std::memcmp(magic, "Obj\x01", 4)) {
    snprintf(err, errlen, "not an Avro container file");
    return false;
  }
  // metadata map: string -> bytes
  auto rl = [&](bool* ok2) { return file_varint(f, ok2); };
  bool ok = true;
  *codec = "null";
  for (;;) {
    int64_t count = rl(&ok);
    if (!ok) { snprintf(err, errlen, "truncated header"); return false; }
    if (count == 0) break;
    if (count < 0) { rl(&ok); count = -count; }
    for (int64_t k = 0; k < count; ++k) {
      int64_t klen = rl(&ok);
      std::string key(klen > 0 ? klen : 0, '\0');
      if (klen > 0 && std::fread(&key[0], 1, klen, f) != (size_t)klen) ok = false;
      int64_t vlen = rl(&ok);
      std::string val(vlen > 0 ? vlen : 0, '\0');
      if (vlen > 0 && std::fread(&val[0], 1, vlen, f) != (size_t)vlen) ok = false;
      if (!ok) { snprintf(err, errlen, "truncated header"); return false; }
      if (key == "avro.codec") *codec = val;
    }
  }
  if (std::fread(sync, 1, 16, f) != 16) {
    snprintf(err, errlen, "truncated sync marker");
    return false;
  }
  return true;
}

}  // namespace

extern "C" {

void* avdec_open(const char* path, const int64_t* plan, int64_t planlen,
                 int64_t n_num, int64_t n_str, int64_t n_bag, int64_t n_map,
                 char* err, uint64_t errlen) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    snprintf(err, errlen, "cannot open %s", path);
    return nullptr;
  }
  std::string codec;
  uint8_t sync[16];
  if (!read_header(f, &codec, sync, err, errlen)) {
    std::fclose(f);
    return nullptr;
  }
  if (codec != "null" && codec != "deflate") {
    snprintf(err, errlen, "unsupported codec %s", codec.c_str());
    std::fclose(f);
    return nullptr;
  }
  auto* h = new Handle();
  h->st.numcols.resize(n_num);
  h->st.numnulls.resize(n_num);
  h->st.strcols.resize(n_str);
  h->st.strpools.resize(n_str);
  h->st.bags.resize(n_bag);
  h->st.maps.resize(n_map);

  std::vector<uint8_t> raw, inflated;
  auto fail = [&](const char* msg) -> void* {
    snprintf(err, errlen, "%s", msg);
    std::fclose(f);
    delete h;
    return nullptr;
  };
  for (;;) {
    int c = std::fgetc(f);
    if (c == EOF) break;
    std::ungetc(c, f);
    bool ok = true;
    int64_t count = file_varint(f, &ok);
    int64_t size = file_varint(f, &ok);
    if (!ok || size < 0) return fail("truncated block header");
    raw.resize(size);
    if (size > 0 && std::fread(raw.data(), 1, size, f) != (size_t)size)
      return fail("truncated block");
    const uint8_t* data = raw.data();
    size_t datalen = raw.size();
    if (codec == "deflate") {
      inflated.clear();
      inflated.resize(std::max<size_t>(datalen * 4, 1 << 16));
      z_stream zs{};
      if (inflateInit2(&zs, -15) != Z_OK) return fail("zlib init failed");
      zs.next_in = const_cast<Bytef*>(raw.data());
      zs.avail_in = raw.size();
      size_t out = 0;
      int zr = Z_OK;
      for (;;) {
        zs.next_out = inflated.data() + out;
        zs.avail_out = inflated.size() - out;
        zr = inflate(&zs, Z_NO_FLUSH);
        out = inflated.size() - zs.avail_out;
        if (zr == Z_STREAM_END) break;
        if (zr != Z_OK) { inflateEnd(&zs); return fail("deflate error"); }
        if (zs.avail_out == 0) inflated.resize(inflated.size() * 2);
      }
      inflateEnd(&zs);
      inflated.resize(out);
      data = inflated.data();
      datalen = out;
    }
    Decoder d{data, data + datalen};
    Exec ex{d, h->st, plan};
    for (int64_t k = 0; k < count; ++k) {
      size_t i = 0;
      ex.run(i);
      if (d.fail || ex.bad_plan)
        return fail(ex.bad_plan ? "bad plan" : "record decode error");
      h->st.row++;
      h->n_records++;
    }
    if (d.p != d.end) return fail("trailing bytes in block");
    uint8_t s2[16];
    if (std::fread(s2, 1, 16, f) != 16 || std::memcmp(s2, sync, 16))
      return fail("sync marker mismatch");
  }
  std::fclose(f);
  // freeze offset views
  for (auto& p : h->st.strpools) h->str_offs.push_back(p.offsets);
  for (auto& b : h->st.bags) h->bag_offs.push_back(b.pool.offsets);
  for (auto& m : h->st.maps) {
    h->mapk_offs.push_back(m.kpool.offsets);
    h->mapv_offs.push_back(m.vpool.offsets);
  }
  return h;
}

int64_t avdec_num_records(void* hv) {
  return static_cast<Handle*>(hv)->n_records;
}

int64_t avdec_numcol(void* hv, int64_t slot, const double** data,
                     const uint8_t** nulls) {
  auto* h = static_cast<Handle*>(hv);
  auto& c = h->st.numcols[slot];
  *data = c.data();
  *nulls = h->st.numnulls[slot].data();
  return static_cast<int64_t>(c.size());
}

int64_t avdec_strcol(void* hv, int64_t slot, const uint32_t** ids,
                     const char** blob, const uint64_t** offs,
                     uint64_t* table_n) {
  auto* h = static_cast<Handle*>(hv);
  auto& c = h->st.strcols[slot];
  *ids = c.data();
  *blob = h->st.strpools[slot].blob.data();
  *offs = h->str_offs[slot].data();
  *table_n = h->st.strpools[slot].ids.size();
  return static_cast<int64_t>(c.size());
}

int64_t avdec_bag(void* hv, int64_t slot, const uint32_t** rows,
                  const uint32_t** keys, const double** vals,
                  const char** blob, const uint64_t** offs,
                  uint64_t* table_n) {
  auto* h = static_cast<Handle*>(hv);
  auto& b = h->st.bags[slot];
  *rows = b.rows.data();
  *keys = b.keys.data();
  *vals = b.vals.data();
  *blob = b.pool.blob.data();
  *offs = h->bag_offs[slot].data();
  *table_n = b.pool.ids.size();
  return static_cast<int64_t>(b.rows.size());
}

int64_t avdec_map(void* hv, int64_t slot, const uint32_t** rows,
                  const uint32_t** keys, const uint32_t** valids,
                  const char** kblob, const uint64_t** koffs, uint64_t* kn,
                  const char** vblob, const uint64_t** voffs, uint64_t* vn) {
  auto* h = static_cast<Handle*>(hv);
  auto& m = h->st.maps[slot];
  *rows = m.rows.data();
  *keys = m.keys.data();
  *valids = m.valids.data();
  *kblob = m.kpool.blob.data();
  *koffs = h->mapk_offs[slot].data();
  *kn = m.kpool.ids.size();
  *vblob = m.vpool.blob.data();
  *voffs = h->mapv_offs[slot].data();
  *vn = m.vpool.ids.size();
  return static_cast<int64_t>(m.rows.size());
}

void avdec_free(void* hv) { delete static_cast<Handle*>(hv); }

}  // extern "C"
