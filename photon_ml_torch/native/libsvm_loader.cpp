// Native LibSVM text parser -> CSR arrays.
//
// Host-side replacement for the reference's JVM-side LibSVM ingestion
// (photon-client io/deprecated/LibSVMInputDataFormat.scala and the
// dev-scripts/libsvm_text_to_trainingexample_avro.py flow): a single-pass
// C++ tokenizer that turns "label idx:val idx:val ..." lines into
// (labels, row_offsets, col_idx, values) CSR buffers, exported to numpy via
// ctypes (see photon_ml_torch/io/libsvm.py). Label-convention mapping
// (±1 -> {0,1}) stays in Python where the task semantics live.
//
// C API (all exported with C linkage):
//   lsvm_parse(path, zero_based, err, err_cap) -> handle or NULL
//   lsvm_num_rows / lsvm_nnz / lsvm_max_index  (handle) -> int64
//   lsvm_export(handle, labels*, row_offsets*, cols*, vals*)
//   lsvm_free(handle)

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct ParsedFile {
  std::vector<double> labels;
  std::vector<uint64_t> row_offsets;  // size rows+1
  std::vector<uint32_t> cols;
  std::vector<double> vals;
  int64_t max_index = -1;
};

bool is_space(char c) { return c == ' ' || c == '\t' || c == '\r'; }

// Parse one buffer; returns false and fills err on malformed input.
bool parse_buffer(const char* data, size_t size, bool zero_based,
                  ParsedFile* out, std::string* err) {
  const char* p = data;
  const char* end = data + size;
  size_t line_no = 0;
  out->row_offsets.push_back(0);
  while (p < end) {
    ++line_no;
    const char* line_end = static_cast<const char*>(memchr(p, '\n', end - p));
    if (line_end == nullptr) line_end = end;
    const char* q = p;
    while (q < line_end && is_space(*q)) ++q;
    if (q == line_end || *q == '#') {  // blank or comment line
      p = line_end + 1;
      continue;
    }
    // label. No ERANGE check: overflow yields ±inf and underflow a denormal,
    // matching Python float() semantics in the fallback parser.
    char* after = nullptr;
    double label = strtod(q, &after);
    if (after == q) {
      *err = "bad label at line " + std::to_string(line_no);
      return false;
    }
    out->labels.push_back(label);
    q = after;
    // idx:val tokens
    while (q < line_end) {
      while (q < line_end && is_space(*q)) ++q;
      if (q >= line_end || *q == '#') break;
      errno = 0;
      char* colon = nullptr;
      long long idx = strtoll(q, &colon, 10);
      if (colon == q || colon >= line_end || *colon != ':' ||
          errno == ERANGE) {
        *err = "bad feature index at line " + std::to_string(line_no);
        return false;
      }
      const char* vstart = colon + 1;
      // Bound the value parse to this line: strtod skips leading whitespace
      // (including '\n'), so a dangling "idx:" token would otherwise
      // silently consume the NEXT line's label as its value.
      if (vstart >= line_end || is_space(*vstart)) {
        *err = "bad feature value at line " + std::to_string(line_no);
        return false;
      }
      double value = strtod(vstart, &after);
      if (after == vstart) {
        *err = "bad feature value at line " + std::to_string(line_no);
        return false;
      }
      if (!zero_based) idx -= 1;
      if (idx < 0 || idx > UINT32_MAX) {
        *err = "feature index out of range at line " + std::to_string(line_no);
        return false;
      }
      out->cols.push_back(static_cast<uint32_t>(idx));
      out->vals.push_back(value);
      if (idx > out->max_index) out->max_index = idx;
      q = after;
    }
    out->row_offsets.push_back(out->cols.size());
    p = line_end + 1;
  }
  return true;
}

void set_err(char* err, uint64_t err_cap, const std::string& msg) {
  if (err != nullptr && err_cap > 0) {
    size_t n = msg.size() < err_cap - 1 ? msg.size() : err_cap - 1;
    memcpy(err, msg.data(), n);
    err[n] = '\0';
  }
}

}  // namespace

extern "C" {

void* lsvm_parse(const char* path, int zero_based, char* err,
                 uint64_t err_cap) try {
  // No exception may cross this extern "C" boundary: bad_alloc /
  // length_error (directory paths make ftell report LONG_MAX) must become
  // error returns, not std::terminate of the host interpreter.
  FILE* f = fopen(path, "rb");
  if (f == nullptr) {
    set_err(err, err_cap, std::string("cannot open ") + path);
    return nullptr;
  }
  long fsize = -1;
  if (fseek(f, 0, SEEK_END) == 0) fsize = ftell(f);
  if (fsize < 0 || fseek(f, 0, SEEK_SET) != 0) {
    fclose(f);
    set_err(err, err_cap, std::string("cannot stat ") + path);
    return nullptr;
  }
  std::string buf;
  buf.resize(static_cast<size_t>(fsize));
  size_t got = fsize > 0 ? fread(&buf[0], 1, buf.size(), f) : 0;
  fclose(f);
  if (got != buf.size()) {
    set_err(err, err_cap, std::string("short read on ") + path);
    return nullptr;
  }
  auto* parsed = new ParsedFile();
  std::string msg;
  if (!parse_buffer(buf.data(), buf.size(), zero_based != 0, parsed, &msg)) {
    delete parsed;
    set_err(err, err_cap, msg + " in " + path);
    return nullptr;
  }
  return parsed;
} catch (const std::exception& e) {
  set_err(err, err_cap, std::string("parse error: ") + e.what());
  return nullptr;
} catch (...) {
  set_err(err, err_cap, "parse error: unknown exception");
  return nullptr;
}

int64_t lsvm_num_rows(void* h) {
  return static_cast<int64_t>(static_cast<ParsedFile*>(h)->labels.size());
}

int64_t lsvm_nnz(void* h) {
  return static_cast<int64_t>(static_cast<ParsedFile*>(h)->cols.size());
}

int64_t lsvm_max_index(void* h) {
  return static_cast<ParsedFile*>(h)->max_index;
}

void lsvm_export(void* h, double* labels, uint64_t* row_offsets,
                 uint32_t* cols, double* vals) {
  auto* p = static_cast<ParsedFile*>(h);
  memcpy(labels, p->labels.data(), p->labels.size() * sizeof(double));
  memcpy(row_offsets, p->row_offsets.data(),
         p->row_offsets.size() * sizeof(uint64_t));
  memcpy(cols, p->cols.data(), p->cols.size() * sizeof(uint32_t));
  memcpy(vals, p->vals.data(), p->vals.size() * sizeof(double));
}

void lsvm_free(void* h) { delete static_cast<ParsedFile*>(h); }

}  // extern "C"
