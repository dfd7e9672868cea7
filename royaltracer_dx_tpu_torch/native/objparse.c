/* Native Wavefront OBJ geometry parser.
 *
 * The TPU-native counterpart of the reference's vendored C++
 * tiny_obj_loader (lib/tiny_obj_loader.h, ~3k LoC) driven from
 * ObjLoader.h:393-495: the asset pipeline is host-side runtime code, so
 * like the reference it is native.  This parser handles the heavy lifting
 * (v/vn/f scanning, value-deduplication, fan triangulation, negative
 * indices); material resolution (mtllib/usemtl -> ids) stays in Python,
 * fed by the statement stream this parser returns in file order.
 *
 * Behavior matches scene/obj_loader.py's pure-Python path exactly:
 *   - vertices dedup on the RESOLVED (position, normal) values
 *   - faces fan-triangulate; each triangle records the current usemtl
 *     "slot" (0 before any usemtl, k after the k-th usemtl statement)
 *   - negative OBJ indices are relative to the current array ends
 *
 * Exposed via ctypes (see native/__init__.py); buffers are malloc'd here
 * and released with obj_free.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <stdio.h>

typedef struct {
    float *verts;      /* [n_verts * 6] pos.xyz | normal.xyz */
    int64_t n_verts;
    int32_t *indices;  /* [n_tris * 3] */
    int32_t *tri_slot; /* [n_tris] usemtl slot per triangle */
    int64_t n_tris;
    char *stmts;       /* '\n'-joined mtllib/usemtl lines, in order */
    int64_t stmts_len;
    int32_t error;     /* 0 ok; 1 malformed; 2 oom */
} ObjResult;

/* ---------------- open-addressing hash of 6-float records -------------- */

typedef struct {
    uint64_t *keys;    /* hash of the 24 bytes; 0 = empty (h forced != 0) */
    int32_t *vals;
    float (*recs)[6];  /* backing records for exact compare */
    int64_t cap;
    int64_t count;
} Table;

static uint64_t hash24(const float *r) {
    /* copy into aligned locals: reading float[6] through uint64_t* is
     * unaligned/strict-aliasing UB */
    uint64_t w[3];
    memcpy(w, r, sizeof(w));
    uint64_t h = 1469598103934665603ull;
    for (int i = 0; i < 3; i++) {
        h ^= w[i];
        h *= 1099511628211ull;
    }
    return h ? h : 1;
}

static int table_init(Table *t, int64_t cap) {
    t->cap = cap;
    t->count = 0;
    t->keys = (uint64_t *)calloc((size_t)cap, sizeof(uint64_t));
    t->vals = (int32_t *)malloc((size_t)cap * sizeof(int32_t));
    return (t->keys && t->vals) ? 0 : -1;
}

/* returns the id for record r, inserting with id = *n_out (incremented)
 * when new; out stores the record at its id.  recs points at the growing
 * output array (kept in sync by the caller). */
static int64_t table_get_or_add(Table *t, const float *r, float (*out)[6],
                                int64_t *n_out) {
    uint64_t h = hash24(r);
    int64_t mask = t->cap - 1;
    int64_t i = (int64_t)(h & (uint64_t)mask);
    for (;;) {
        if (t->keys[i] == 0) {
            t->keys[i] = h;
            t->vals[i] = (int32_t)*n_out;
            memcpy(out[*n_out], r, 6 * sizeof(float));
            return (*n_out)++;
        }
        if (t->keys[i] == h && memcmp(out[t->vals[i]], r, 24) == 0)
            return t->vals[i];
        i = (i + 1) & mask;
    }
}

/* ------------------------------ parsing -------------------------------- */

static const char *skip_ws(const char *p, const char *end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
    return p;
}

static const char *next_line(const char *p, const char *end) {
    while (p < end && *p != '\n') p++;
    return p < end ? p + 1 : end;
}

static int64_t round_pow2(int64_t x) {
    int64_t p = 64;
    while (p < x) p <<= 1;
    return p;
}

ObjResult *obj_parse(const char *data, int64_t len) {
    ObjResult *res = (ObjResult *)calloc(1, sizeof(ObjResult));
    if (!res) return NULL;
    const char *end = data + len;

    /* pass 1: count v / vn / face corners / statement bytes */
    int64_t n_v = 0, n_vn = 0, n_corners = 0, stmt_bytes = 0;
    for (const char *p = data; p < end; p = next_line(p, end)) {
        p = skip_ws(p, end);
        if (p + 1 >= end) continue;
        if (p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) n_v++;
        else if (p[0] == 'v' && p[1] == 'n') n_vn++;
        else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
            const char *q = p + 1, *e = p;
            while (e < end && *e != '\n') e++;
            int in_tok = 0;
            for (; q < e; q++) {
                int ws = (*q == ' ' || *q == '\t' || *q == '\r');
                if (!ws && !in_tok) { n_corners++; in_tok = 1; }
                else if (ws) in_tok = 0;
            }
        } else if (!strncmp(p, "mtllib", 6) || !strncmp(p, "usemtl", 6)) {
            const char *e = p;
            while (e < end && *e != '\n') e++;
            stmt_bytes += (e - p) + 1;
        }
    }

    float *pos = (float *)malloc((size_t)(n_v ? n_v : 1) * 3 * sizeof(float));
    float *nrm = (float *)malloc((size_t)(n_vn ? n_vn : 1) * 3 * sizeof(float));
    /* worst case every corner is a unique vertex; tris <= corners */
    float (*out)[6] = (float (*)[6])malloc(
        (size_t)(n_corners ? n_corners : 1) * 6 * sizeof(float));
    res->indices = (int32_t *)malloc(
        (size_t)(n_corners ? n_corners : 1) * 3 * sizeof(int32_t));
    res->tri_slot = (int32_t *)malloc(
        (size_t)(n_corners ? n_corners : 1) * sizeof(int32_t));
    res->stmts = (char *)malloc((size_t)(stmt_bytes ? stmt_bytes : 1));
    /* vertex ids are int32 on the wire; anything larger must fall back to
     * the Python parser rather than truncate */
    if (n_corners >= INT32_MAX) {
        res->error = 1;
        free(pos); free(nrm); free(out);
        return res;
    }
    Table table = {0};
    if (!pos || !nrm || !out || !res->indices || !res->tri_slot || !res->stmts
        || table_init(&table, round_pow2(2 * (n_corners ? n_corners : 1)))) {
        res->error = 2;
        free(pos); free(nrm); free(out);
        free(table.keys); free(table.vals);
        return res;
    }

    int64_t iv = 0, ivn = 0, n_out = 0, n_tris = 0, stmt_off = 0;
    int32_t slot = 0;
    int32_t face[256];
    for (const char *p = data; p < end; p = next_line(p, end)) {
        p = skip_ws(p, end);
        if (p + 1 >= end) continue;
        if (p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
            char *q = (char *)p + 1;
            pos[iv * 3 + 0] = strtof(q, &q);
            pos[iv * 3 + 1] = strtof(q, &q);
            pos[iv * 3 + 2] = strtof(q, &q);
            iv++;
        } else if (p[0] == 'v' && p[1] == 'n') {
            char *q = (char *)p + 2;
            nrm[ivn * 3 + 0] = strtof(q, &q);
            nrm[ivn * 3 + 1] = strtof(q, &q);
            nrm[ivn * 3 + 2] = strtof(q, &q);
            ivn++;
        } else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
            const char *e = p;
            while (e < end && *e != '\n') e++;
            const char *q = p + 1;
            int nf = 0;
            /* faces are capped at 256 corners; larger polygons error out
             * (error=1) below so the caller falls back to the Python
             * parser instead of silently dropping geometry */
            while (q < e && nf < 256) {
                q = skip_ws(q, e);
                if (q >= e) break;
                char *qq = (char *)q;
                long vi = strtol(qq, &qq, 10);
                long ni = 0;
                int has_n = 0;
                if (*qq == '/') {             /* v/vt or v//vn or v/vt/vn */
                    qq++;
                    if (*qq != '/') strtol(qq, &qq, 10);   /* vt, ignored */
                    if (*qq == '/') {
                        qq++;
                        ni = strtol(qq, &qq, 10);
                        has_n = 1;
                    }
                }
                int64_t vidx = vi > 0 ? vi - 1 : iv + vi;
                int64_t nidx = has_n ? (ni > 0 ? ni - 1 : ivn + ni) : -1;
                if (vidx < 0 || vidx >= iv || (has_n && (nidx < 0 || nidx >= ivn))) {
                    res->error = 1;
                    free(pos); free(nrm); free(out);
                    free(table.keys); free(table.vals);
                    return res;
                }
                float rec[6];
                memcpy(rec, pos + vidx * 3, 3 * sizeof(float));
                if (nidx >= 0) memcpy(rec + 3, nrm + nidx * 3, 3 * sizeof(float));
                else rec[3] = rec[4] = rec[5] = 0.0f;
                face[nf++] = (int32_t)table_get_or_add(&table, rec, out, &n_out);
                q = qq;
            }
            if (nf == 256 && skip_ws(q, e) < e) {   /* >256-corner face */
                res->error = 1;
                free(pos); free(nrm); free(out);
                free(table.keys); free(table.vals);
                return res;
            }
            for (int k = 1; k + 1 < nf; k++) {
                res->indices[n_tris * 3 + 0] = face[0];
                res->indices[n_tris * 3 + 1] = face[k];
                res->indices[n_tris * 3 + 2] = face[k + 1];
                res->tri_slot[n_tris] = slot;
                n_tris++;
            }
        } else if (!strncmp(p, "mtllib", 6) || !strncmp(p, "usemtl", 6)) {
            const char *e = p;
            while (e < end && *e != '\n' && *e != '\r') e++;
            memcpy(res->stmts + stmt_off, p, (size_t)(e - p));
            stmt_off += e - p;
            res->stmts[stmt_off++] = '\n';
            if (!strncmp(p, "usemtl", 6)) slot++;
        }
    }

    res->verts = (float *)out;
    res->n_verts = n_out;
    res->n_tris = n_tris;
    res->stmts_len = stmt_off;
    free(pos);
    free(nrm);
    free(table.keys);
    free(table.vals);
    return res;
}

void obj_free(ObjResult *res) {
    if (!res) return;
    free(res->verts);
    free(res->indices);
    free(res->tri_slot);
    free(res->stmts);
    free(res);
}
