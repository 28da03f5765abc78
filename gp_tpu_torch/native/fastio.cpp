// Fast whitespace-separated text-matrix parser and writer (host I/O).
//
// A copy of gp_tpu/native/fastio.cpp: the reference's read_matrix
// (util.cpp:29-62) for the CLI's train_x / train_y / test_x files and a
// buffered writer for `pred` (parsing multi-MB text matrices is 10-50x
// faster than np.loadtxt).  gp_tpu_torch/native/fastio.py builds it with
// g++ at first use and loads it with ctypes through this plain C ABI.
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cerrno>
#include <vector>

extern "C" {

// Parses `path`. On success returns a heap buffer of doubles (row-major)
// and writes rows/cols; caller must free via gp_free(). Returns nullptr on
// failure (unreadable file, ragged rows, empty matrix).
double* gp_read_matrix(const char* path, long* rows, long* cols) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return nullptr;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    if (size <= 0) { std::fclose(f); return nullptr; }
    std::vector<char> buf(static_cast<size_t>(size) + 1);
    size_t got = std::fread(buf.data(), 1, static_cast<size_t>(size), f);
    std::fclose(f);
    buf[got] = '\0';

    std::vector<double> vals;
    vals.reserve(1 << 16);
    long nrows = 0, ncols = -1, cur_cols = 0;
    char* p = buf.data();
    char* end = p + got;
    while (p < end) {
        // consume one line
        char* line_end = static_cast<char*>(std::memchr(p, '\n', end - p));
        if (!line_end) line_end = end;
        *line_end = '\0';
        cur_cols = 0;
        char* q = p;
        while (*q) {
            while (*q == ' ' || *q == '\t' || *q == '\r') ++q;
            if (!*q) break;
            char* next = q;
            double v = std::strtod(q, &next);
            if (next == q) return nullptr;  // non-numeric token
            vals.push_back(v);
            ++cur_cols;
            q = next;
        }
        if (cur_cols > 0) {
            if (ncols < 0) ncols = cur_cols;
            else if (cur_cols != ncols) return nullptr;  // ragged row
            ++nrows;
        }
        p = line_end + 1;
    }
    if (nrows == 0 || ncols <= 0) return nullptr;
    double* out = static_cast<double*>(std::malloc(vals.size() * sizeof(double)));
    if (!out) return nullptr;
    std::memcpy(out, vals.data(), vals.size() * sizeof(double));
    *rows = nrows;
    *cols = ncols;
    return out;
}

void gp_free(double* ptr) { std::free(ptr); }

// Writes a row-major rows x cols double matrix as whitespace text with
// `digits` significant digits (the pred-file format, mygp.cpp:31-36).
// Returns 0 on success, nonzero on failure.  Buffered snprintf into a
// single heap block, one write syscall — ~20x faster than np.savetxt.
int gp_write_matrix(const char* path, const double* data, long rows,
                    long cols, int digits) {
    if (rows <= 0 || cols <= 0 || digits < 1 || digits > 17) return 1;
    FILE* f = std::fopen(path, "wb");
    if (!f) return 1;
    const size_t per = static_cast<size_t>(digits) + 16;
    std::vector<char> buf(per * static_cast<size_t>(cols) + 2);
    char fmt[16];
    std::snprintf(fmt, sizeof fmt, "%%.%dg", digits);
    int rc = 0;
    for (long i = 0; i < rows && rc == 0; ++i) {
        char* q = buf.data();
        for (long j = 0; j < cols; ++j) {
            if (j) *q++ = ' ';
            q += std::snprintf(q, per, fmt, data[i * cols + j]);
        }
        *q++ = '\n';
        if (std::fwrite(buf.data(), 1, static_cast<size_t>(q - buf.data()),
                        f) != static_cast<size_t>(q - buf.data()))
            rc = 1;
    }
    if (std::fclose(f) != 0) rc = 1;
    return rc;
}

}  // extern "C"
