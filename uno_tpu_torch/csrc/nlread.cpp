// Native AMPL .nl reader — text format ("g") AND binary format ("b").
//
// The port's copy of uno_tpu/io/nlread.cpp: the code is the same, only this
// header differs.  It replaces the IO half of the reference's ASL bindings
// (bindings/AMPL/AMPLModel.cpp:19-80 — ASL_alloc/pfgh_read): parses the .nl
// expression graphs into flat postfix token streams plus bounds/linear-part
// arrays.  Differentiation is NOT done here (ASL computes derivatives in C);
// instead uno_tpu_torch/io/nl.py replays the postfix programs as torch
// operations, so gradients/Jacobians/Hessians come from torch.func.
//
// Binary format (per D. Gay, "Writing .nl Files" / the ASL readers): the
// 10 header lines stay ASCII (line 1 begins with 'b'; field 3 of line 6 is
// the arith kind: 1 = IEEE little-endian, 2 = IEEE big-endian), segment
// letters, expression-node type characters ('o','v','n','s','l') and
// bound-code digits remain single bytes, while every number is native
// binary: 4-byte ints, 2-byte shorts ('s' consts), 8-byte doubles.  No
// whitespace or newlines appear between binary fields.  Byte-swapping is
// applied when the declared arith kind opposes the host's.
//
// Also exposes nl_to_binary(): a text→binary transcriber (the parser run
// with a tee) used to produce binary fixtures and to let users convert.
//
// Exposed as a C API consumed via ctypes (no pybind11 in this environment).
//
// Build:  g++ -O2 -shared -fPIC -o libnlread.so nlread.cpp

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <cmath>
#include <string>
#include <vector>

namespace {

struct Token {
    int32_t op;    // >=0: ASL opcode; -1: const; -2: variable reference
    double num;    // const value / variable index / n-ary arity
};

inline bool host_is_little_endian() {
    const uint16_t one = 1;
    return *reinterpret_cast<const uint8_t*>(&one) == 1;
}

inline void bswap(void* p, size_t n) {
    uint8_t* b = static_cast<uint8_t*>(p);
    for (size_t i = 0, j = n - 1; i < j; ++i, --j) {
        uint8_t t = b[i]; b[i] = b[j]; b[j] = t;
    }
}

struct Parser {
    FILE* f = nullptr;
    FILE* out = nullptr;      // text→binary transcription target (text mode only)
    bool bin = false;         // input is binary
    bool swap = false;        // byteswap binary fields (input arith != host)
    std::string pending;      // digits glued to a segment/node head (text mode)
    std::string err;

    bool fail(const std::string& msg) {
        if (err.empty()) err = msg;
        return false;
    }

    // ---- text tokenizer ----
    bool next_tok(std::string& o) {
        o.clear();
        int c;
        while ((c = fgetc(f)) != EOF) {
            if (c == '#') {                 // comment to end of line
                while ((c = fgetc(f)) != EOF && c != '\n') {}
                if (!o.empty()) return true;
                continue;
            }
            if (isspace(c)) {
                if (!o.empty()) return true;
                continue;
            }
            o.push_back(static_cast<char>(c));
        }
        return !o.empty();
    }

    // ---- emission (text→binary transcription) ----
    void emit_kind(char k) { if (out) fputc(k, out); }
    void emit_int(long v) {
        if (out) { int32_t x = static_cast<int32_t>(v); fwrite(&x, 4, 1, out); }
    }
    void emit_short(long v) {
        if (out) { int16_t x = static_cast<int16_t>(v); fwrite(&x, 2, 1, out); }
    }
    void emit_double(double v) { if (out) fwrite(&v, 8, 1, out); }

    // ---- unified lexical API (auto-emits when transcribing) ----

    // next segment letter or expression-node type char; false at clean EOF
    bool next_kind(char& k) {
        if (bin) {
            int c = fgetc(f);
            if (c == EOF) return false;
            k = static_cast<char>(c);
            return true;
        }
        std::string t;
        if (!next_tok(t)) return false;
        k = t[0];
        pending = t.substr(1);
        emit_kind(k);
        return true;
    }

    // integer glued to the head in text ("C5", "o2"); separate 4-byte int in binary
    bool head_int(long& v) {
        if (bin) return read_i32(v);
        v = strtol(pending.c_str(), nullptr, 10);
        emit_int(v);
        return true;
    }

    // double glued to the head in text ("n1.5"); 8-byte double in binary
    bool head_double(double& v) {
        if (bin) return read_f64(v);
        v = strtod(pending.c_str(), nullptr);
        emit_double(v);
        return true;
    }

    bool head_short(long& v) {   // 's' short const ("s5" / 2-byte short)
        if (bin) {
            int16_t x;
            if (fread(&x, 2, 1, f) != 1) return fail("unexpected EOF (short)");
            if (swap) bswap(&x, 2);
            v = x;
            return true;
        }
        v = strtol(pending.c_str(), nullptr, 10);
        emit_short(v);
        return true;
    }

    bool next_int(long& v) {
        if (bin) return read_i32(v);
        std::string s;
        if (!next_tok(s)) return fail("unexpected EOF (int)");
        v = strtol(s.c_str(), nullptr, 10);
        emit_int(v);
        return true;
    }

    bool next_double(double& v) {
        if (bin) return read_f64(v);
        std::string s;
        if (!next_tok(s)) return fail("unexpected EOF (double)");
        v = strtod(s.c_str(), nullptr);
        emit_double(v);
        return true;
    }

    // bound code: single ASCII digit byte in BOTH formats
    bool next_code(long& v) {
        if (bin) {
            int c = fgetc(f);
            if (c == EOF) return fail("unexpected EOF (bound code)");
            v = c - '0';
            return true;
        }
        std::string s;
        if (!next_tok(s)) return fail("unexpected EOF (bound code)");
        v = strtol(s.c_str(), nullptr, 10);
        emit_kind(static_cast<char>('0' + v));
        return true;
    }

    // suffix name: whitespace token in text; bytes-to-newline in binary
    bool next_name(std::string& o) {
        if (bin) {
            o.clear();
            int c;
            while ((c = fgetc(f)) != EOF && c != '\n')
                o.push_back(static_cast<char>(c));
            return true;
        }
        if (!next_tok(o)) return fail("unexpected EOF (name)");
        if (out) { fwrite(o.data(), 1, o.size(), out); fputc('\n', out); }
        return true;
    }

    bool read_i32(long& v) {
        int32_t x;
        if (fread(&x, 4, 1, f) != 1) return fail("unexpected EOF (int)");
        if (swap) bswap(&x, 4);
        v = x;
        return true;
    }

    bool read_f64(double& v) {
        double x;
        if (fread(&x, 8, 1, f) != 1) return fail("unexpected EOF (double)");
        if (swap) bswap(&x, 8);
        v = x;
        return true;
    }

    // parse one prefix expression, emit postfix into o
    bool parse_expr(std::vector<Token>& o) {
        char kind;
        if (!next_kind(kind)) return fail("unexpected EOF (expr)");
        if (kind == 'n') {                    // numeric constant
            double v;
            if (!head_double(v)) return false;
            o.push_back({-1, v});
            return true;
        }
        if (kind == 's') {                    // short constant (binary files)
            long v;
            if (!head_short(v)) return false;
            o.push_back({-1, static_cast<double>(v)});
            return true;
        }
        if (kind == 'l') {                    // long constant
            long v;
            if (!head_int(v)) return false;
            o.push_back({-1, static_cast<double>(v)});
            return true;
        }
        if (kind == 'v') {                    // variable (or defined variable)
            long v;
            if (!head_int(v)) return false;
            o.push_back({-2, static_cast<double>(v)});
            return true;
        }
        if (kind != 'o') return fail(std::string("unexpected token '") + kind +
                                     "' in expression");
        long op;
        if (!head_int(op)) return false;
        int arity;
        switch (op) {
            // unary
            case 13: case 14: case 15: case 16: case 34:
            case 37: case 38: case 39: case 40: case 41: case 42: case 43:
            case 44: case 45: case 46: case 47: case 49: case 50: case 51:
            case 52: case 53: case 76: case 77: case 78:
                arity = 1; break;
            // binary
            case 0: case 1: case 2: case 3: case 4: case 5: case 6:
            case 20: case 21: case 22: case 23: case 24: case 28: case 29:
            case 30: case 48: case 55:
                arity = 2; break;
            case 35:                          // if-then-else
                arity = 3; break;
            case 11: case 12: case 54: {      // min/max/sum lists
                long count;
                if (!next_int(count)) return false;
                for (long i = 0; i < count; ++i)
                    if (!parse_expr(o)) return false;
                o.push_back({static_cast<int32_t>(op), static_cast<double>(count)});
                return true;
            }
            default:
                return fail("unsupported opcode o" + std::to_string(op));
        }
        for (int i = 0; i < arity; ++i)
            if (!parse_expr(o)) return false;
        o.push_back({static_cast<int32_t>(op), 0.0});
        return true;
    }
};

}  // namespace

extern "C" {

struct NLData {
    int32_t n_vars, n_cons, n_objs, n_defined;
    int32_t objective_sense;      // 0 = minimize, 1 = maximize
    double *x_lb, *x_ub, *c_lb, *c_ub, *x0, *y0;
    int32_t jac_nnz; int32_t *jac_row, *jac_col; double* jac_val;
    int32_t grad_nnz; int32_t *grad_col; double* grad_val;
    int32_t n_tokens; int32_t* tok_op; double* tok_num;
    int32_t *con_expr_off;        // [n_cons + 1]
    int32_t *obj_expr_off;        // [2]
    int32_t *def_expr_off;        // [n_defined + 1]
    int32_t *def_index;           // [n_defined] variable index of each defined var
    int32_t deflin_nnz; int32_t *deflin_def, *deflin_col; double* deflin_val;
    char error[512];
};

static double* dup_vec(const std::vector<double>& v) {
    double* p = static_cast<double*>(malloc(sizeof(double) * (v.empty() ? 1 : v.size())));
    memcpy(p, v.data(), sizeof(double) * v.size());
    return p;
}
static int32_t* dup_ivec(const std::vector<int32_t>& v) {
    int32_t* p = static_cast<int32_t*>(malloc(sizeof(int32_t) * (v.empty() ? 1 : v.size())));
    memcpy(p, v.data(), sizeof(int32_t) * v.size());
    return p;
}

// Parse `path` into *d.  When `binary_out` is non-null the input must be
// text format and a binary-format transcript is written there.
static void nl_parse_impl(const char* path, NLData* d, const char* binary_out) {
    Parser P;
    P.f = fopen(path, "rb");
    if (!P.f) {
        snprintf(d->error, sizeof(d->error), "cannot open %s", path);
        return;
    }

    // ---- header ----
    // line 1: 'g' (text) or 'b' (binary), possibly followed by option ints
    {
        int c = fgetc(P.f);
        if (c == 'b') {
            P.bin = true;
        } else if (c != 'g') {
            snprintf(d->error, sizeof(d->error),
                     ".nl must begin with 'g' (text) or 'b' (binary)");
            fclose(P.f);
            return;
        }
        if (P.bin && binary_out) {
            snprintf(d->error, sizeof(d->error),
                     "nl_to_binary input must be text format");
            fclose(P.f);
            return;
        }
        if (binary_out) {
            P.out = fopen(binary_out, "wb");
            if (!P.out) {
                snprintf(d->error, sizeof(d->error), "cannot open %s", binary_out);
                fclose(P.f);
                return;
            }
            fputc('b', P.out);   // rest of line 1 copied below
        }
        std::string rest;
        while ((c = fgetc(P.f)) != EOF && c != '\n')
            rest.push_back(static_cast<char>(c));
        if (P.out) { fwrite(rest.data(), 1, rest.size(), P.out); fputc('\n', P.out); }
    }
    long nv = 0, nc = 0, no = 0, nrange = 0, neq = 0;
    {
        // header lines 2..10 are ASCII in both formats (robust to per-line
        // field-count variations between AMPL versions); line 2 starts with
        // "vars constraints objectives ranges eqns"; line 6 field 3 is the
        // arith kind for binary files (1 = IEEE LSB-first, 2 = MSB-first)
        char buf[1024];
        for (int line = 2; line <= 10; ++line) {
            if (!fgets(buf, sizeof(buf), P.f)) {
                snprintf(d->error, sizeof(d->error), "truncated .nl header");
                goto done;
            }
            if (line == 2) {
                if (sscanf(buf, " %ld %ld %ld %ld %ld", &nv, &nc, &no,
                           &nrange, &neq) < 3) {
                    snprintf(d->error, sizeof(d->error), "bad .nl header line 2");
                    goto done;
                }
            }
            if (line == 6) {
                long nwv = 0, nfunc = 0, arith = 0, flags = 0;
                int got = sscanf(buf, " %ld %ld %ld %ld",
                                 &nwv, &nfunc, &arith, &flags);
                if (P.bin) {
                    const long host = host_is_little_endian() ? 1 : 2;
                    if (arith != 0 && arith != host) {
                        if (arith == 1 || arith == 2) {
                            P.swap = true;
                        } else {
                            snprintf(d->error, sizeof(d->error),
                                     "unsupported arith kind %ld (not IEEE)", arith);
                            goto done;
                        }
                    }
                }
                if (P.out) {
                    // declare the host's IEEE byte order in the transcript
                    fprintf(P.out, " %ld %ld %ld %ld\n", nwv, nfunc,
                            host_is_little_endian() ? 1L : 2L,
                            got >= 4 ? flags : 0L);
                    continue;
                }
            }
            if (P.out) fwrite(buf, 1, strlen(buf), P.out);
        }
    }

    {
        std::vector<double> x_lb(nv, -INFINITY), x_ub(nv, INFINITY);
        std::vector<double> c_lb(nc, -INFINITY), c_ub(nc, INFINITY);
        std::vector<double> x0(nv, 0.0), y0(nc, 0.0);
        std::vector<int32_t> jr, jc; std::vector<double> jv;
        std::vector<int32_t> gc; std::vector<double> gv;
        std::vector<Token> toks;
        std::vector<int32_t> con_off(nc + 1, 0), obj_off(2, 0);
        std::vector<int32_t> def_off{0};
        std::vector<int32_t> def_index;
        std::vector<int32_t> dl_def, dl_col; std::vector<double> dl_val;
        std::vector<std::vector<Token>> con_exprs(nc), obj_exprs(1);
        std::vector<std::vector<Token>> def_exprs;
        d->objective_sense = 0;

        char k;
        while (P.next_kind(k)) {
            if (k == 'C') {
                long i;
                if (!P.head_int(i)) goto emit;
                if (i < 0 || i >= nc) { P.fail("bad C index"); goto emit; }
                if (!P.parse_expr(con_exprs[i])) goto emit;
            } else if (k == 'O') {
                long i, sense;
                if (!P.head_int(i) || !P.next_int(sense)) goto emit;
                if (i == 0) d->objective_sense = static_cast<int32_t>(sense);
                std::vector<Token> tmp;
                if (!P.parse_expr(tmp)) goto emit;
                if (i == 0) obj_exprs[0] = std::move(tmp);
            } else if (k == 'V') {
                // defined variable: "V<idx> <nlin> <where>" + linear part + expr
                long idx, nlin, where;
                if (!P.head_int(idx) || !P.next_int(nlin) || !P.next_int(where))
                    goto emit;
                for (long t = 0; t < nlin; ++t) {
                    long col; double val;
                    if (!P.next_int(col) || !P.next_double(val)) goto emit;
                    dl_def.push_back(static_cast<int32_t>(def_index.size()));
                    dl_col.push_back(static_cast<int32_t>(col));
                    dl_val.push_back(val);
                }
                std::vector<Token> tmp;
                if (!P.parse_expr(tmp)) goto emit;
                def_index.push_back(static_cast<int32_t>(idx));
                def_exprs.push_back(std::move(tmp));
            } else if (k == 'b') {
                for (long i = 0; i < nv; ++i) {
                    long code;
                    if (!P.next_code(code)) goto emit;
                    double lo, hi;
                    switch (code) {
                        case 0: if (!P.next_double(lo) || !P.next_double(hi)) goto emit;
                                x_lb[i] = lo; x_ub[i] = hi; break;
                        case 1: if (!P.next_double(hi)) goto emit; x_ub[i] = hi; break;
                        case 2: if (!P.next_double(lo)) goto emit; x_lb[i] = lo; break;
                        case 3: break;
                        case 4: if (!P.next_double(lo)) goto emit;
                                x_lb[i] = x_ub[i] = lo; break;
                        default: P.fail("unsupported bound code in b"); goto emit;
                    }
                }
            } else if (k == 'r') {
                for (long i = 0; i < nc; ++i) {
                    long code;
                    if (!P.next_code(code)) goto emit;
                    double lo, hi;
                    switch (code) {
                        case 0: if (!P.next_double(lo) || !P.next_double(hi)) goto emit;
                                c_lb[i] = lo; c_ub[i] = hi; break;
                        case 1: if (!P.next_double(hi)) goto emit; c_ub[i] = hi; break;
                        case 2: if (!P.next_double(lo)) goto emit; c_lb[i] = lo; break;
                        case 3: break;
                        case 4: if (!P.next_double(lo)) goto emit;
                                c_lb[i] = c_ub[i] = lo; break;
                        default: P.fail("unsupported bound code in r"); goto emit;
                    }
                }
            } else if (k == 'x') {
                long count;
                if (!P.head_int(count)) goto emit;
                for (long t = 0; t < count; ++t) {
                    long idx; double val;
                    if (!P.next_int(idx) || !P.next_double(val)) goto emit;
                    if (idx >= 0 && idx < nv) x0[idx] = val;
                }
            } else if (k == 'd') {
                long count;
                if (!P.head_int(count)) goto emit;
                for (long t = 0; t < count; ++t) {
                    long idx; double val;
                    if (!P.next_int(idx) || !P.next_double(val)) goto emit;
                    if (idx >= 0 && idx < nc) y0[idx] = val;
                }
            } else if (k == 'k') {
                long count;
                if (!P.head_int(count)) goto emit;
                long dummy;
                for (long t = 0; t < count; ++t)
                    if (!P.next_int(dummy)) goto emit;
            } else if (k == 'J') {
                long i, count;
                if (!P.head_int(i) || !P.next_int(count)) goto emit;
                for (long t = 0; t < count; ++t) {
                    long col; double val;
                    if (!P.next_int(col) || !P.next_double(val)) goto emit;
                    jr.push_back(static_cast<int32_t>(i));
                    jc.push_back(static_cast<int32_t>(col));
                    jv.push_back(val);
                }
            } else if (k == 'G') {
                long i, count;
                if (!P.head_int(i) || !P.next_int(count)) goto emit;
                for (long t = 0; t < count; ++t) {
                    long col; double val;
                    if (!P.next_int(col) || !P.next_double(val)) goto emit;
                    if (i == 0) {
                        gc.push_back(static_cast<int32_t>(col));
                        gv.push_back(val);
                    }
                }
            } else if (k == 'S') {
                // suffix: "S<kind> <n> <name>" + n (idx, value) pairs; values
                // are ints unless kind & 4; parsed (to stay in sync) and skipped
                long kind, count; std::string name;
                if (!P.head_int(kind) || !P.next_int(count) || !P.next_name(name))
                    goto emit;
                for (long t = 0; t < count; ++t) {
                    long idx;
                    if (!P.next_int(idx)) goto emit;
                    if (kind & 4) {
                        double val;
                        if (!P.next_double(val)) goto emit;
                    } else {
                        long val;
                        if (!P.next_int(val)) goto emit;
                    }
                }
            } else if (k == 'F' || k == 'L') {
                P.fail(std::string("unsupported segment '") + k + "'");
                goto emit;
            } else {
                P.fail(std::string("unknown segment '") + k + "'");
                goto emit;
            }
        }

    emit:
        // flatten expressions into one token stream with offsets
        for (long i = 0; i < nc; ++i) {
            con_off[i] = static_cast<int32_t>(toks.size());
            toks.insert(toks.end(), con_exprs[i].begin(), con_exprs[i].end());
        }
        con_off[nc] = static_cast<int32_t>(toks.size());
        obj_off[0] = static_cast<int32_t>(toks.size());
        toks.insert(toks.end(), obj_exprs[0].begin(), obj_exprs[0].end());
        obj_off[1] = static_cast<int32_t>(toks.size());
        def_off.assign(1, static_cast<int32_t>(toks.size()));
        for (auto& e : def_exprs) {
            toks.insert(toks.end(), e.begin(), e.end());
            def_off.push_back(static_cast<int32_t>(toks.size()));
        }

        d->n_vars = static_cast<int32_t>(nv);
        d->n_cons = static_cast<int32_t>(nc);
        d->n_objs = static_cast<int32_t>(no);
        d->n_defined = static_cast<int32_t>(def_exprs.size());
        d->x_lb = dup_vec(x_lb); d->x_ub = dup_vec(x_ub);
        d->c_lb = dup_vec(c_lb); d->c_ub = dup_vec(c_ub);
        d->x0 = dup_vec(x0); d->y0 = dup_vec(y0);
        d->jac_nnz = static_cast<int32_t>(jv.size());
        d->jac_row = dup_ivec(jr); d->jac_col = dup_ivec(jc); d->jac_val = dup_vec(jv);
        d->grad_nnz = static_cast<int32_t>(gv.size());
        d->grad_col = dup_ivec(gc); d->grad_val = dup_vec(gv);
        d->n_tokens = static_cast<int32_t>(toks.size());
        {
            std::vector<int32_t> ops(toks.size());
            std::vector<double> nums(toks.size());
            for (size_t i = 0; i < toks.size(); ++i) {
                ops[i] = toks[i].op;
                nums[i] = toks[i].num;
            }
            d->tok_op = dup_ivec(ops);
            d->tok_num = dup_vec(nums);
        }
        d->con_expr_off = dup_ivec(con_off);
        d->obj_expr_off = dup_ivec(obj_off);
        d->def_expr_off = dup_ivec(def_off);
        d->def_index = dup_ivec(def_index);
        d->deflin_nnz = static_cast<int32_t>(dl_val.size());
        d->deflin_def = dup_ivec(dl_def);
        d->deflin_col = dup_ivec(dl_col);
        d->deflin_val = dup_vec(dl_val);
        if (!P.err.empty())
            snprintf(d->error, sizeof(d->error), "%s", P.err.c_str());
    }

done:
    if (P.f) fclose(P.f);
    if (P.out) fclose(P.out);
    if (d->error[0] == 0 && !P.err.empty())
        snprintf(d->error, sizeof(d->error), "%s", P.err.c_str());
}

NLData* nl_parse(const char* path) {
    NLData* d = static_cast<NLData*>(calloc(1, sizeof(NLData)));
    nl_parse_impl(path, d, nullptr);
    return d;
}

// Convert a text-format .nl to binary format.  Returns 0 on success; on
// failure writes a message into errbuf and returns 1.
int nl_to_binary(const char* in_path, const char* out_path,
                 char* errbuf, int errlen) {
    NLData* d = static_cast<NLData*>(calloc(1, sizeof(NLData)));
    nl_parse_impl(in_path, d, out_path);
    int rc = d->error[0] ? 1 : 0;
    if (rc && errbuf && errlen > 0)
        snprintf(errbuf, errlen, "%s", d->error);
    // free via nl_free (arrays were allocated unless the header failed early)
    void nl_free(NLData*);
    nl_free(d);
    return rc;
}

void nl_free(NLData* d) {
    if (!d) return;
    free(d->x_lb); free(d->x_ub); free(d->c_lb); free(d->c_ub);
    free(d->x0); free(d->y0);
    free(d->jac_row); free(d->jac_col); free(d->jac_val);
    free(d->grad_col); free(d->grad_val);
    free(d->tok_op); free(d->tok_num);
    free(d->con_expr_off); free(d->obj_expr_off); free(d->def_expr_off);
    free(d->def_index);
    free(d->deflin_def); free(d->deflin_col); free(d->deflin_val);
    free(d);
}

}  // extern "C"
