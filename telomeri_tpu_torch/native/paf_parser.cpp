// Fast PAF parser (C API consumed via ctypes from telomeri_tpu_torch/native/paf_native.py).
//
// Reference parity: the C++ reference tool parses PAF natively (SURVEY.md §3 row 3;
// the reference mount was empty — SURVEY.md §0); this is the TPU-framework's native
// ingest path. Semantics are defined by the pure-Python parser
// telomeri_tpu_torch/io/paf.py::_parse_columns_py and enforced by tests/test_native.py:
//   - tab-separated, >= 11 columns, empty lines skipped, trailing \r stripped
//   - columns used: qname qlen qstart qend strand tname tlen tstart tend nmatch blocklen
//   - strand must be '+' or '-' (encoded 0/1)
//   - first error wins and is reported as "<path>:<line>: <message>"
//
// Build: python -m telomeri_tpu_torch.native.build  (g++ -O3 -shared -fPIC)

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct PafFile {
    std::vector<int64_t> ints;      // 9 per row: qlen qs qe strand tlen ts te nm bl
    std::string qnames;             // concatenated name bytes
    std::string tnames;
    std::vector<int64_t> qoff;      // nrows+1 offsets into qnames
    std::vector<int64_t> toff;
    std::string error;              // empty = ok
    int64_t nrows = 0;
};

// Parse a non-negative integer; returns false on garbage.
bool parse_i64(const char* b, const char* e, int64_t* out) {
    if (b == e) return false;
    int64_t v = 0;
    bool neg = false;
    if (*b == '-') { neg = true; ++b; if (b == e) return false; }
    for (; b != e; ++b) {
        if (*b < '0' || *b > '9') return false;
        v = v * 10 + (*b - '0');
    }
    *out = neg ? -v : v;
    return true;
}

void parse_buffer(PafFile* pf, const char* data, size_t size, const char* path) {
    const char* p = data;
    const char* end = data + size;
    int64_t lineno = 0;
    pf->qoff.push_back(0);
    pf->toff.push_back(0);
    char msg[256];

    while (p < end) {
        ++lineno;
        const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
        const char* le = nl ? nl : end;
        if (le > p && le[-1] == '\r') --le;
        if (le == p) { p = nl ? nl + 1 : end; continue; }  // empty line

        // split into up to 11 columns (rest of the line ignored, like Python)
        const char* cb[12];
        const char* ce[12];
        int ncol = 0;
        const char* q = p;
        while (ncol < 11) {
            const char* tab = static_cast<const char*>(memchr(q, '\t', le - q));
            cb[ncol] = q;
            ce[ncol] = tab && tab < le ? tab : le;
            ++ncol;
            if (!tab || tab >= le) break;
            q = tab + 1;
        }
        if (ncol < 11) {
            snprintf(msg, sizeof msg, "%s:%lld: PAF row has %d < 11 columns",
                     path, static_cast<long long>(lineno), ncol);
            pf->error = msg;
            return;
        }
        int64_t strand;
        if (ce[4] - cb[4] == 1 && *cb[4] == '+') strand = 0;
        else if (ce[4] - cb[4] == 1 && *cb[4] == '-') strand = 1;
        else {
            snprintf(msg, sizeof msg, "%s:%lld: bad strand '%.8s'",
                     path, static_cast<long long>(lineno), cb[4]);
            pf->error = msg;
            return;
        }
        static const int icols[8] = {1, 2, 3, 6, 7, 8, 9, 10};
        int64_t vals[8];
        for (int k = 0; k < 8; ++k) {
            if (!parse_i64(cb[icols[k]], ce[icols[k]], &vals[k])) {
                snprintf(msg, sizeof msg, "%s:%lld: bad integer in column %d",
                         path, static_cast<long long>(lineno), icols[k] + 1);
                pf->error = msg;
                return;
            }
        }
        pf->ints.push_back(vals[0]);  // qlen
        pf->ints.push_back(vals[1]);  // qstart
        pf->ints.push_back(vals[2]);  // qend
        pf->ints.push_back(strand);
        pf->ints.push_back(vals[3]);  // tlen
        pf->ints.push_back(vals[4]);  // tstart
        pf->ints.push_back(vals[5]);  // tend
        pf->ints.push_back(vals[6]);  // nmatch
        pf->ints.push_back(vals[7]);  // blocklen
        pf->qnames.append(cb[0], ce[0] - cb[0]);
        pf->tnames.append(cb[5], ce[5] - cb[5]);
        pf->qoff.push_back(static_cast<int64_t>(pf->qnames.size()));
        pf->toff.push_back(static_cast<int64_t>(pf->tnames.size()));
        ++pf->nrows;
        p = nl ? nl + 1 : end;
    }
}

}  // namespace

extern "C" {

void* tel_parse_paf(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::string buf;
    buf.resize(size < 0 ? 0 : static_cast<size_t>(size));
    if (size > 0 && fread(&buf[0], 1, buf.size(), f) != buf.size()) {
        fclose(f);
        return nullptr;
    }
    fclose(f);

    PafFile* pf = new PafFile();
    parse_buffer(pf, buf.data(), buf.size(), path);
    if (!pf->error.empty()) {
        // keep handle so the caller can read the error
        pf->nrows = 0;
    }
    return pf;
}

int64_t tel_paf_nrows(void* h) { return static_cast<PafFile*>(h)->nrows; }

const char* tel_paf_error(void* h) {
    PafFile* pf = static_cast<PafFile*>(h);
    return pf->error.empty() ? nullptr : pf->error.c_str();
}

void tel_paf_fill(void* h, int64_t* ints, int64_t* qoff, int64_t* toff) {
    PafFile* pf = static_cast<PafFile*>(h);
    memcpy(ints, pf->ints.data(), pf->ints.size() * sizeof(int64_t));
    memcpy(qoff, pf->qoff.data(), pf->qoff.size() * sizeof(int64_t));
    memcpy(toff, pf->toff.data(), pf->toff.size() * sizeof(int64_t));
}

int64_t tel_paf_names_bytes(void* h, int which) {
    PafFile* pf = static_cast<PafFile*>(h);
    return static_cast<int64_t>((which == 0 ? pf->qnames : pf->tnames).size());
}

void tel_paf_copy_names(void* h, int which, char* out) {
    PafFile* pf = static_cast<PafFile*>(h);
    const std::string& s = which == 0 ? pf->qnames : pf->tnames;
    memcpy(out, s.data(), s.size());
}

void tel_paf_free(void* h) { delete static_cast<PafFile*>(h); }

}  // extern "C"

// ---------------------------------------------------------------------------
// FASTA/FASTQ parser (semantics defined by telomeri_tpu_torch/io/fasta.py; parity
// enforced by tests/test_native.py). Names are the first whitespace token of the
// header; multi-line FASTA concatenated; FASTQ quality lines ignored; CRLF ok.

namespace {

struct FastxFile {
    std::string names;              // concatenated name bytes
    std::string seqs;               // concatenated sequence bytes
    std::vector<int64_t> name_off;  // n+1
    std::vector<int64_t> seq_off;   // n+1
    std::string error;
    int64_t nseqs = 0;
};

const char* skip_ws(const char* b, const char* e) {
    while (b < e && (*b == ' ' || *b == '\t')) ++b;
    return b;
}

const char* first_token_end(const char* b, const char* e) {
    while (b < e && *b != ' ' && *b != '\t') ++b;
    return b;
}

void parse_fastx_buffer(FastxFile* ff, const char* data, size_t size,
                        const char* path) {
    const char* p = data;
    const char* end = data + size;
    char msg[256];
    ff->name_off.push_back(0);
    ff->seq_off.push_back(0);
    if (size == 0) return;

    if (*p == '>') {  // FASTA
        bool in_seq = false;
        while (p < end) {
            const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
            const char* le = nl ? nl : end;
            if (le > p && le[-1] == '\r') --le;
            if (le > p) {
                if (*p == '>') {
                    if (in_seq) {
                        ff->seq_off.push_back(static_cast<int64_t>(ff->seqs.size()));
                    }
                    const char* nb = skip_ws(p + 1, le);
                    const char* ne = first_token_end(nb, le);
                    if (ne == nb) {
                        snprintf(msg, sizeof msg,
                                 "%s: FASTA header with empty sequence name", path);
                        ff->error = msg;
                        return;
                    }
                    ff->names.append(nb, ne - nb);
                    ff->name_off.push_back(static_cast<int64_t>(ff->names.size()));
                    ++ff->nseqs;
                    in_seq = true;
                } else {
                    ff->seqs.append(p, le - p);
                }
            }
            p = nl ? nl + 1 : end;
        }
        if (in_seq) ff->seq_off.push_back(static_cast<int64_t>(ff->seqs.size()));
        return;
    }

    if (*p == '@') {  // FASTQ: 4-line records
        int64_t lineno = 0;
        while (p < end) {
            // header
            ++lineno;
            const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
            const char* le = nl ? nl : end;
            if (le > p && le[-1] == '\r') --le;
            if (le == p) { p = nl ? nl + 1 : end; continue; }
            if (*p != '@') {
                snprintf(msg, sizeof msg,
                         "%s: FASTQ record %lld: expected '@'", path,
                         static_cast<long long>(ff->nseqs));
                ff->error = msg;
                return;
            }
            const char* nb = skip_ws(p + 1, le);
            const char* ne = first_token_end(nb, le);
            if (ne == nb) {
                snprintf(msg, sizeof msg,
                         "%s: FASTQ header with empty sequence name", path);
                ff->error = msg;
                return;
            }
            ff->names.append(nb, ne - nb);
            ff->name_off.push_back(static_cast<int64_t>(ff->names.size()));
            p = nl ? nl + 1 : end;
            if (p >= end) {
                snprintf(msg, sizeof msg,
                         "%s: FASTQ record %lld: truncated (header has no sequence "
                         "line)", path, static_cast<long long>(ff->nseqs));
                ff->error = msg;
                return;
            }
            // sequence
            nl = static_cast<const char*>(memchr(p, '\n', end - p));
            le = nl ? nl : end;
            if (le > p && le[-1] == '\r') --le;
            ff->seqs.append(p, le - p);
            ff->seq_off.push_back(static_cast<int64_t>(ff->seqs.size()));
            ++ff->nseqs;
            p = nl ? nl + 1 : end;
            // '+' line and quality line: skipped
            for (int skip = 0; skip < 2 && p < end; ++skip) {
                nl = static_cast<const char*>(memchr(p, '\n', end - p));
                p = nl ? nl + 1 : end;
            }
        }
        return;
    }

    snprintf(msg, sizeof msg, "%s: not FASTA/FASTQ (first byte 0x%02x)", path,
             static_cast<unsigned char>(*p));
    ff->error = msg;
}

}  // namespace

extern "C" {

void* tel_parse_fastx(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::string buf;
    buf.resize(size < 0 ? 0 : static_cast<size_t>(size));
    if (size > 0 && fread(&buf[0], 1, buf.size(), f) != buf.size()) {
        fclose(f);
        return nullptr;
    }
    fclose(f);
    FastxFile* ff = new FastxFile();
    parse_fastx_buffer(ff, buf.data(), buf.size(), path);
    return ff;
}

int64_t tel_fastx_nseqs(void* h) { return static_cast<FastxFile*>(h)->nseqs; }

const char* tel_fastx_error(void* h) {
    FastxFile* ff = static_cast<FastxFile*>(h);
    return ff->error.empty() ? nullptr : ff->error.c_str();
}

int64_t tel_fastx_names_bytes(void* h) {
    return static_cast<int64_t>(static_cast<FastxFile*>(h)->names.size());
}

int64_t tel_fastx_seqs_bytes(void* h) {
    return static_cast<int64_t>(static_cast<FastxFile*>(h)->seqs.size());
}

void tel_fastx_fill(void* h, char* names, int64_t* name_off, char* seqs,
                    int64_t* seq_off) {
    FastxFile* ff = static_cast<FastxFile*>(h);
    memcpy(names, ff->names.data(), ff->names.size());
    memcpy(name_off, ff->name_off.data(), ff->name_off.size() * sizeof(int64_t));
    memcpy(seqs, ff->seqs.data(), ff->seqs.size());
    memcpy(seq_off, ff->seq_off.data(), ff->seq_off.size() * sizeof(int64_t));
}

void tel_fastx_free(void* h) { delete static_cast<FastxFile*>(h); }

}  // extern "C"

extern "C" {

// zero-copy accessors: pointers into the C++-owned buffers (valid until
// tel_fastx_free). The Python side wraps these as numpy views and frees the
// handle from a finalizer — avoids a full-corpus memcpy, which matters on this
// host (measured ~50 MB/s RAM copies).
const char* tel_fastx_names_ptr(void* h) {
    return static_cast<FastxFile*>(h)->names.data();
}
const char* tel_fastx_seqs_ptr(void* h) {
    return static_cast<FastxFile*>(h)->seqs.data();
}
const int64_t* tel_fastx_name_off_ptr(void* h) {
    return static_cast<FastxFile*>(h)->name_off.data();
}
const int64_t* tel_fastx_seq_off_ptr(void* h) {
    return static_cast<FastxFile*>(h)->seq_off.data();
}

}  // extern "C"
