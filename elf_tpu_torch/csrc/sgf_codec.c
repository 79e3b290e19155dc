/* Native SGF / move-string codec: the port's copy of the JAX package's
 * `native/sgf_codec.c`, same functions and the same results.
 *
 * Host-side counterpart of the reference's C++ SGF layer
 * (sgf/sgf.{h,cc}): the compact move-list wire format `coords2sgfstr` /
 * `sgfstr2coords` (sgf.h:87/:97) used in every game record, plus a
 * main-line SGF parser for bulk offline loading (Sgf::load + iterator).
 * The training server decodes every record it receives with it.
 *
 * Built at first use by `elf_tpu_torch/_build.py` with the host C compiler
 * into build/kernels/sgf_codec-<hash>.so.
 * API (ctypes, `elf_tpu_torch/native/sgf_codec.py`):
 *   int moves_to_sgfstr(int size, const int32_t* moves, int n,
 *                       char* out, int cap);            // returns length
 *   int sgfstr_to_moves(const char* s, int size,
 *                       int32_t* out, int cap);          // returns count
 *   int parse_sgf_main(const char* text, int32_t* out_moves, int cap,
 *                      int* out_size, double* out_komi, int* out_handicap,
 *                      char* out_result, int result_cap); // returns count
 * All return -1 on malformed input / capacity overflow.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>
#include <stdlib.h>

/* ---------------- compact move-string codec ---------------- */

int moves_to_sgfstr(int size, const int32_t *moves, int n, char *out,
                    int cap) {
  if (size <= 0 || size > 25 || n < 0) return -1;
  int n2 = size * size;
  int w = 0;
  if (w + 1 >= cap) return -1;
  out[w++] = '(';
  for (int i = 0; i < n; i++) {
    int m = moves[i];
    if (m < 0 || m > n2) return -1;
    /* ";B[xy]" or ";B[]" for pass */
    int need = (m < n2) ? 6 : 4;
    if (w + need + 2 > cap) return -1;
    out[w++] = ';';
    out[w++] = (i % 2 == 0) ? 'B' : 'W';
    out[w++] = '[';
    if (m < n2) {
      out[w++] = (char)('a' + m % size); /* col */
      out[w++] = (char)('a' + m / size); /* row */
    }
    out[w++] = ']';
  }
  if (w + 2 > cap) return -1;
  out[w++] = ')';
  out[w] = '\0';
  return w;
}

int sgfstr_to_moves(const char *s, int size, int32_t *out, int cap) {
  if (size <= 0 || size > 25 || s == NULL) return -1;
  int n2 = size * size;
  int n = 0;
  const char *p = s;
  if (*p != '(') return 0;
  p++;
  while (*p == ';') {
    const char *br = strchr(p, '[');
    if (!br) break;
    const char *end = strchr(br, ']');
    if (!end) return -1;
    long len = end - br - 1;
    int32_t m;
    if (len == 0) {
      m = n2; /* pass */
    } else if (len == 2) {
      int c = br[1] - 'a';
      int r = br[2] - 'a';
      if (c == 19 && r == 19 && size <= 19) {
        m = n2; /* legacy 'tt' pass */
      } else {
        if (r < 0 || r >= size || c < 0 || c >= size) return -1;
        m = r * size + c;
      }
    } else {
      return -1;
    }
    if (n >= cap) return -1;
    out[n++] = m;
    p = end + 1;
  }
  return n;
}

/* ---------------- main-line SGF parser ---------------- */

#define MAX_SGF_DEPTH 128

/* skip a balanced (...) group starting at text[*ip] == '(' ,
   honoring bracketed values with '\' escapes.  returns 0 ok / -1 bad. */
static int skip_group(const char *t, size_t len, size_t *ip) {
  size_t i = *ip;
  int depth = 0;
  while (i < len) {
    char c = t[i];
    if (c == '[') {
      i++;
      while (i < len && t[i] != ']') {
        if (t[i] == '\\' && i + 1 < len) i++;
        i++;
      }
      if (i >= len) return -1;
      i++;
    } else if (c == '(') {
      depth++;
      i++;
    } else if (c == ')') {
      depth--;
      i++;
      if (depth == 0) {
        *ip = i;
        return 0;
      }
    } else {
      i++;
    }
  }
  return -1;
}

int parse_sgf_main(const char *text, int32_t *out_moves, int cap,
                   int *out_size, double *out_komi, int *out_handicap,
                   char *out_result, int result_cap) {
  if (!text) return -1;
  size_t len = strlen(text);
  size_t i = 0;
  int depth = 0;
  unsigned char seen[MAX_SGF_DEPTH];
  memset(seen, 0, sizeof(seen));

  int size = 19;
  double komi = 0.0;
  int handicap = 0;
  if (result_cap > 0) out_result[0] = '\0';

  /* moves stored as (row, col) until the final size is known; pass = -1 */
  int16_t *rs = (int16_t *)malloc(sizeof(int16_t) * (size_t)(cap > 0 ? cap : 1));
  int16_t *cs = (int16_t *)malloc(sizeof(int16_t) * (size_t)(cap > 0 ? cap : 1));
  int n = 0;
  if (!rs || !cs) {
    free(rs);
    free(cs);
    return -1;
  }

#define FAIL()        \
  do {                \
    free(rs);         \
    free(cs);         \
    return -1;        \
  } while (0)

  while (i < len) {
    char c = text[i];
    if (c == '(') {
      if (depth >= MAX_SGF_DEPTH - 1) FAIL();
      if (seen[depth]) {
        if (skip_group(text, len, &i) != 0) FAIL();
      } else {
        seen[depth] = 1;
        depth++;
        seen[depth] = 0;
        i++;
      }
    } else if (c == ')') {
      if (depth <= 0) FAIL();
      depth--;
      i++;
    } else if (c == ';' || c == ' ' || c == '\n' || c == '\r' || c == '\t') {
      i++;
    } else if (c >= 'A' && c <= 'Z') {
      /* property ident */
      char ident[8];
      int il = 0;
      while (i < len && text[i] >= 'A' && text[i] <= 'Z') {
        if (il < 7) ident[il++] = text[i];
        i++;
      }
      ident[il] = '\0';
      /* lowercase letters inside idents (old SGF) are skipped */
      while (i < len && text[i] >= 'a' && text[i] <= 'z') i++;
      int first_value = 1;
      while (1) {
        while (i < len && (text[i] == ' ' || text[i] == '\n' ||
                           text[i] == '\r' || text[i] == '\t'))
          i++;
        if (i >= len || text[i] != '[') break;
        i++; /* consume '[' */
        char val[256];
        int vl = 0;
        while (i < len && text[i] != ']') {
          char vc = text[i];
          if (vc == '\\' && i + 1 < len) {
            i++;
            vc = text[i];
          }
          if (vl < 255) val[vl++] = vc;
          i++;
        }
        if (i >= len) FAIL();
        i++; /* consume ']' */
        val[vl] = '\0';
        if (first_value) {
          first_value = 0;
          if ((ident[0] == 'B' || ident[0] == 'W') && ident[1] == '\0') {
            int16_t r = -1, col = -1;
            if (vl == 2) {
              col = (int16_t)(val[0] - 'a');
              r = (int16_t)(val[1] - 'a');
              /* 'tt' (19,19) resolves at the end: pass on <=19 boards */
            } else if (vl != 0) {
              FAIL(); /* malformed move value */
            }
            if (n >= cap) FAIL();
            rs[n] = r;
            cs[n] = col;
            n++;
          } else if (strcmp(ident, "SZ") == 0) {
            int v = atoi(val);
            if (v >= 1 && v <= 25) size = v;
          } else if (strcmp(ident, "KM") == 0) {
            komi = atof(val);
          } else if (strcmp(ident, "HA") == 0) {
            handicap = atoi(val);
          } else if (strcmp(ident, "RE") == 0) {
            if (result_cap > 0) {
              int rl = vl < result_cap - 1 ? vl : result_cap - 1;
              memcpy(out_result, val, (size_t)rl);
              out_result[rl] = '\0';
            }
          }
        }
        /* further values of multi-value props (AB[..][..]) are consumed
           and ignored */
      }
    } else {
      i++;
    }
  }

  int n2 = size * size;
  for (int k = 0; k < n; k++) {
    if (rs[k] < 0 || (rs[k] == 19 && cs[k] == 19 && size <= 19)) {
      out_moves[k] = n2; /* pass (empty value, or legacy 'tt') */
    } else if (rs[k] >= size || cs[k] >= size) {
      FAIL();
    } else {
      out_moves[k] = rs[k] * size + cs[k];
    }
  }
  if (out_size) *out_size = size;
  if (out_komi) *out_komi = komi;
  if (out_handicap) *out_handicap = handicap;
  free(rs);
  free(cs);
  return n;
#undef FAIL
}
