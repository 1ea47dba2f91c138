// Native host core for the STC-007 stitcher: per-block deinterleave
// correction (the hot op behind every seam-padding trial and the final
// deinterleave).  Semantics are EXACTLY ops/deinterleave.py::correct_blocks
// (the vectorized port of the reference's processBlock decision tree,
// stc007deinterleaver.cpp:286-1123); the numpy path stays as the
// reference implementation and tests assert bit-identity.
//
// GF(2) matrix tables (T^k, (T^k+I)^-1; stc007deinterleaver.cpp:4-75) are
// NOT duplicated here — Python passes the row masks from formats/gf2.py
// via stc007_set_q_tables, keeping one source of truth.
//
// Build: g++ -O3 -fopenmp -shared -fPIC -o libsdvstitch.so stitchcore.cpp
// (the loader falls back to a serial build when -fopenmp is missing).
//
// Multicore: the frame-batch binarizers and the block eval sweep carry
// `omp parallel for` over their outer loops — every iteration writes a
// disjoint output row with purely local state, so results are
// bit-identical for any thread count (OMP_NUM_THREADS; 1 core -> serial).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int N_WORDS = 8;
constexpr int N_AUDIO = 6;
constexpr int WORD_P0 = 6;
constexpr int WORD_Q0 = 7;
constexpr int NO_ERR = 64;

// audio_state
constexpr int AUD_ORIG = 0, AUD_FIX_P = 1, AUD_FIX_Q = 2, AUD_BROKEN = 3;
// stage
constexpr int STG_DATA_OK = 0, STG_NO_CHECK = 1, STG_BAD_BLOCK = 2;

// Row-mask tables set from Python (gf2.MATRICES): tpow_rows[k+6] is T^k
// for k in -6..6, inv_rows[d-1] is (T^d+I)^-1 for d in 1..5.
static uint16_t g_tpow[13][14];
static uint16_t g_inv[5][14];
static bool g_tables_set = false;

// Byte-sliced lookup twins of the row masks (built once in
// stc007_set_q_tables): apply(w) = lo[w & 0xFF] ^ hi[bits 8..13].
// Replaces 14 AND+parity steps per matrix apply with two L1 loads;
// ~12 KB total, resident in L1.
static uint16_t g_tpow_lo[13][256], g_tpow_hi[13][64];
static uint16_t g_inv_lo[5][256], g_inv_hi[5][64];

inline int32_t gf2_apply(const uint16_t rows[14], int32_t word) {
    int32_t out = 0;
    for (int r = 0; r < 14; ++r) {
        out |= (__builtin_parity(rows[r] & (uint32_t)word) << r);
    }
    return out;
}

inline int32_t tpow_apply(int k, int32_t w) {
    return g_tpow_lo[k + 6][w & 0xFF] ^ g_tpow_hi[k + 6][(w >> 8) & 0x3F];
}
inline int32_t inv_apply(int d, int32_t w) {
    return g_inv_lo[d - 1][w & 0xFF] ^ g_inv_hi[d - 1][(w >> 8) & 0x3F];
}

inline int32_t calc_p(const int32_t* w) {
    return w[0] ^ w[1] ^ w[2] ^ w[3] ^ w[4] ^ w[5];
}

inline int32_t calc_q(const int32_t* w) {
    int32_t q = 0;
    for (int k = 0; k < 6; ++k) q ^= tpow_apply(6 - k, w[k]);
    return q;
}

}  // namespace

namespace {

constexpr int F1_S_OFFSETS[7] = {12, 10, 8, 6, 4, 2, 0};
constexpr int F1_WORD_OFS = 2;
constexpr int F1_S_MASK = 0x0003;
constexpr int BIT_M2_RANGE = 1 << 13;
constexpr int BIT_M2_SIGN = 1 << 12;

// res modes (ops/deinterleave.py:44)
constexpr int M14 = 0, M14A = 1, M16A = 2, M16 = 3;

struct BlockResult {
    int32_t w[8];
    uint8_t valid[8];
    uint8_t lcrc[8];
    int32_t state;
    int32_t stage;
};

// One-block port of the correct_blocks loop body above.
inline void correct_one(const int32_t* w_in, const uint8_t* c_in, bool is14,
                        bool en_p, bool en_q, bool force_ecc,
                        BlockResult* r) {
    const bool q_active = is14 && en_q;
    const int tot_limit = is14 ? N_WORDS : 7;
    int32_t* w = r->w;
    uint8_t* valid = r->valid;
    uint8_t* lcrc = r->lcrc;
    for (int i = 0; i < N_WORDS; ++i) {
        w[i] = w_in[i];
        valid[i] = c_in[i];
        lcrc[i] = c_in[i];
    }
    int state = AUD_ORIG;
    int stage = STG_BAD_BLOCK;
    int first = NO_ERR, second = NO_ERR, aud_errs = 0, tot_errs = 0;
    for (int i = 0; i < N_AUDIO; ++i) {
        if (!c_in[i]) {
            ++aud_errs;
            if (first == NO_ERR) first = i;
            else if (second == NO_ERR) second = i;
        }
    }
    for (int i = 0; i < tot_limit; ++i) tot_errs += !c_in[i];
    const bool p_ok = c_in[WORD_P0], q_ok = c_in[WORD_Q0];
    const int32_t sp = calc_p(w) ^ w[WORD_P0];
    // Every consumer of sq sits behind q_active, so P-only evals
    // (getFieldResolution, en_q=0) skip the Q syndrome entirely.
    const int32_t sq = q_active ? (calc_q(w) ^ w[WORD_Q0]) : 0;
    const bool le2 = tot_errs <= 2;

    if (le2 && aud_errs == 0) {
        if (!force_ecc) {
            stage = STG_DATA_OK;
        } else if (!en_p) {
            stage = STG_NO_CHECK;
        } else if (p_ok) {
            if (sp == 0) {
                stage = STG_DATA_OK;
                if (q_active) {
                    // No audio word was modified since sq, so
                    // calc_q(w) ^ w[Q0] is still sq — no recompute.
                    if (q_ok && sq != 0) {
                        state = AUD_BROKEN;
                        stage = STG_BAD_BLOCK;
                    } else if (!q_ok) {
                        int32_t nq = sq ^ w[WORD_Q0];
                        if (nq != w[WORD_Q0]) lcrc[WORD_Q0] = 0;
                        w[WORD_Q0] = nq;
                        valid[WORD_Q0] = 1;
                    }
                }
            } else {
                state = AUD_BROKEN;
            }
        } else {
            if (q_active) {
                if (!q_ok) {
                    stage = STG_NO_CHECK;
                    // P0/Q0 rebuilds: audio words untouched, so
                    // calc_q(w) = sq ^ original Q0 (read before the
                    // overwrite below); calc_p likewise via sp.
                    int32_t nq = sq ^ w[WORD_Q0];
                    w[WORD_P0] = sp ^ w[WORD_P0];
                    w[WORD_Q0] = nq;
                    valid[WORD_P0] = valid[WORD_Q0] = 1;
                    lcrc[WORD_P0] = lcrc[WORD_Q0] = 0;
                } else if (sq == 0) {
                    stage = STG_DATA_OK;
                    int32_t np = calc_p(w);
                    if (np != w[WORD_P0]) lcrc[WORD_P0] = 0;
                    w[WORD_P0] = np;
                    valid[WORD_P0] = 1;
                } else {
                    state = AUD_BROKEN;
                }
            } else {
                stage = STG_NO_CHECK;
            }
        }
    } else if (le2 && aud_errs == 1 && en_p) {
        bool went_p_route = false;
        if (p_ok) {
            went_p_route = true;
            if (sp == 0) {
                valid[first] = 1;
            } else {
                w[first] ^= sp;
                valid[first] = 1;
                lcrc[first] = 0;
            }
            stage = STG_DATA_OK;
            state = AUD_FIX_P;
        } else if (q_active && q_ok) {
            if (sq == 0) {
                valid[first] = 1;
                int32_t np = calc_p(w);
                if (np != w[WORD_P0]) lcrc[WORD_P0] = 0;
                w[WORD_P0] = np;
                valid[WORD_P0] = 1;
                stage = STG_DATA_OK;
                state = AUD_FIX_Q;
            } else {
                int32_t e1 = tpow_apply(-(6 - first), sq);
                int32_t e2 = e1 ^ sp;
                if (e1 != 0) { w[first] ^= e1; lcrc[first] = 0; }
                valid[first] = 1;
                if (e2 != 0) { w[WORD_P0] ^= e2; lcrc[WORD_P0] = 0; }
                valid[WORD_P0] = 1;
                stage = STG_DATA_OK;
                state = AUD_FIX_Q;
            }
        }
        if (went_p_route && q_active) {
            // The only audio-word change on the P route was
            // w[first] ^= sp (sp != 0 case); Q is linear, so the
            // syndrome moves by T^(6-first) sp — no full recompute.
            const int32_t sq_fixed =
                sp ? (sq ^ tpow_apply(6 - first, sp)) : sq;
            if (force_ecc) {
                if (q_ok && sq_fixed != 0) {
                    state = AUD_BROKEN;
                    stage = STG_BAD_BLOCK;
                }
            }
            if (!q_ok) {
                int32_t nq = sq_fixed ^ w[WORD_Q0];
                if (nq != w[WORD_Q0]) lcrc[WORD_Q0] = 0;
                w[WORD_Q0] = nq;
                valid[WORD_Q0] = 1;
            }
        }
    } else if (le2 && aud_errs == 2 && q_active && q_ok && p_ok) {
        if (sp == 0 && sq == 0) {
            valid[first] = valid[second] = 1;
            stage = STG_DATA_OK;
            state = AUD_FIX_Q;
        } else {
            int d = second - first;
            int32_t e1 = inv_apply(d, tpow_apply(-(6 - second), sq) ^ sp);
            int32_t e2 = e1 ^ sp;
            if (e1 != 0) { w[first] ^= e1; lcrc[first] = 0; }
            valid[first] = 1;
            if (e2 != 0) { w[second] ^= e2; lcrc[second] = 0; }
            valid[second] = 1;
            stage = STG_DATA_OK;
            state = AUD_FIX_Q;
        }
    }
    if (state == AUD_BROKEN) {
        for (int i = 0; i < tot_limit; ++i) { valid[i] = 0; lcrc[i] = 0; }
    }
    r->state = state;
    r->stage = stage;
}

// correct_blocks_cwd semantics for one block (ops/deinterleave.py:479-512).
inline bool correct_one_cwd(const int32_t* w_in, const uint8_t* c_in,
                            const uint8_t* cwd_b, bool is14, bool en_p,
                            bool en_q, bool force_ecc, bool en_cwd,
                            BlockResult* r) {
    correct_one(w_in, c_in, is14, en_p, en_q, force_ecc, r);
    if (!en_cwd) return false;
    const int tot_limit = is14 ? N_WORDS : 7;
    int raw_tot = 0, raw_aud = 0;
    bool helpful = false;
    for (int i = 0; i < tot_limit; ++i) {
        raw_tot += !c_in[i];
        if (cwd_b[i] && !c_in[i]) helpful = true;
    }
    for (int i = 0; i < N_AUDIO; ++i) raw_aud += !c_in[i];
    const bool enters = raw_tot > 2 || (raw_aud == 2 && !is14);
    if (!(enters && helpful)) return false;
    uint8_t eff[8];
    for (int i = 0; i < N_WORDS; ++i) eff[i] = c_in[i] | cwd_b[i];
    correct_one(w_in, eff, is14, en_p, en_q, force_ecc, r);
    // line_crc keeps RAW source CRC state for CWD blocks.
    for (int i = 0; i < N_WORDS; ++i) r->lcrc[i] = c_in[i];
    return true;
}

inline int16_t expand14(int32_t word, bool m2) {
    int32_t w = word & 0x3FFF;
    int32_t out;
    if (!m2) {
        out = (w << 2) & 0xFFFF;
    } else if ((w & BIT_M2_RANGE) == 0) {
        out = (w << 3) & 0xFFFF;
    } else {
        int32_t lo = w & ~BIT_M2_RANGE;
        if (w & BIT_M2_SIGN)
            lo |= (1 << 15) | (1 << 14) | BIT_M2_RANGE;
        out = lo;
    }
    if (out >= 0x8000) out -= 0x10000;
    return (int16_t)out;
}

}  // namespace

extern "C" {

void stc007_set_q_tables(const uint16_t* tpow_rows, const uint16_t* inv_rows) {
    std::memcpy(g_tpow, tpow_rows, sizeof(g_tpow));
    std::memcpy(g_inv, inv_rows, sizeof(g_inv));
    for (int k = 0; k < 13; ++k) {
        for (int b = 0; b < 256; ++b)
            g_tpow_lo[k][b] = (uint16_t)gf2_apply(g_tpow[k], b);
        for (int b = 0; b < 64; ++b)
            g_tpow_hi[k][b] = (uint16_t)gf2_apply(g_tpow[k], b << 8);
    }
    for (int d = 0; d < 5; ++d) {
        for (int b = 0; b < 256; ++b)
            g_inv_lo[d][b] = (uint16_t)gf2_apply(g_inv[d], b);
        for (int b = 0; b < 64; ++b)
            g_inv_hi[d][b] = (uint16_t)gf2_apply(g_inv[d], b << 8);
    }
    g_tables_set = true;
}

// words_in/words_out [B*8] int32; crc_in/valid_out/line_crc_out [B*8] u8;
// audio_state_out/stage_out [B] int32.  resolution: 0 = 14-bit, 1 = 16-bit.
// In-place aliasing of in/out buffers is NOT allowed.
int stc007_correct_blocks(
    const int32_t* words_in, const uint8_t* crc_in, int64_t B,
    int32_t resolution, int32_t en_p, int32_t en_q, int32_t force_ecc,
    int32_t* words_out, uint8_t* valid_out, uint8_t* line_crc_out,
    int32_t* audio_state_out, int32_t* stage_out) {
    if (!g_tables_set) return -1;
    const bool is14 = resolution == 0;
    for (int64_t b = 0; b < B; ++b) {
        BlockResult r;
        correct_one(words_in + b * N_WORDS, crc_in + b * N_WORDS, is14,
                    en_p, en_q, force_ecc, &r);
        for (int i = 0; i < N_WORDS; ++i) {
            words_out[b * N_WORDS + i] = r.w[i];
            valid_out[b * N_WORDS + i] = r.valid[i];
            line_crc_out[b * N_WORDS + i] = r.lcrc[i];
        }
        audio_state_out[b] = r.state;
        stage_out[b] = r.stage;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Whole-seam evaluation: gather + per-block correction + derived flags +
// samples in one call (the hot loop behind eval_rows / tryPadding /
// getFieldResolution / performDeinterleave).  Semantics are EXACTLY
// pipeline/stitcher_stc007.py::eval_rows over ops/deinterleave.py.
// ---------------------------------------------------------------------------

// Full seam evaluation over B blocks.
//   line_words [L*8] int32, line_crc [L*8] u8 (crc_ok incl. forced-bad),
//   cwd_line   [L] u8 or NULL,
//   rows       [B*8] int64 or NULL (NULL -> contiguous shifts from `start`)
// Outputs (all preallocated by the caller):
//   words [B*8] i64, valid/lcrc [B*8] u8, state/stage/resolution [B] i32,
//   flags [B] u8 (bit0 broken, 1 block_valid, 2 can_force, 3 silent,
//                 4 fixed_p, 5 fixed_q, 6 cwd_applied),
//   samples [B*6] i16.
int stc007_eval_rows(
    const int32_t* line_words, const uint8_t* line_crc,
    const uint8_t* cwd_line, const int64_t* rows, int64_t start, int64_t B,
    int32_t res_mode, int32_t en_p, int32_t en_q, int32_t force_ecc,
    int32_t en_cwd, int32_t m2,
    int64_t* words_out, uint8_t* valid_out, uint8_t* lcrc_out,
    int32_t* state_out, int32_t* stage_out, int32_t* res_out,
    uint8_t* flags_out, int16_t* samples_out) {
    if (!g_tables_set) return -1;

    #pragma omp parallel for schedule(static) if (B > 512)
    for (int64_t b = 0; b < B; ++b) {
        int64_t rb[8];
        if (rows) {
            for (int i = 0; i < 8; ++i) rb[i] = rows[b * 8 + i];
        } else {
            for (int i = 0; i < 8; ++i) rb[i] = start + b + 16 * i;
        }
        int32_t w14[8];
        uint8_t c14[8];
        uint8_t cwd_b[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        for (int i = 0; i < 8; ++i) {
            w14[i] = line_words[rb[i] * 8 + i];
            c14[i] = line_crc[rb[i] * 8 + i];
            if (cwd_line) cwd_b[i] = cwd_line[rb[i]];
        }

        auto run = [&](bool is14, BlockResult* r, bool* cwd_app) {
            if (is14) {
                *cwd_app = correct_one_cwd(w14, c14, cwd_b, true, en_p,
                                           en_q, force_ecc, en_cwd, r);
            } else {
                int32_t w16[8];
                uint8_t c16[8];
                for (int i = 0; i < 7; ++i) {
                    int32_t s = line_words[rb[i] * 8 + WORD_Q0];
                    w16[i] = (w14[i] << F1_WORD_OFS)
                           + ((s >> F1_S_OFFSETS[i]) & F1_S_MASK);
                    c16[i] = c14[i] && line_crc[rb[i] * 8 + WORD_Q0];
                }
                w16[7] = 0;
                c16[7] = 1;
                *cwd_app = correct_one_cwd(w16, c16, cwd_b, false, en_p,
                                           en_q, force_ecc, en_cwd, r);
            }
        };

        BlockResult r;
        bool cwd_app = false;
        bool is14_sel;
        if (res_mode == M14 || res_mode == M16) {
            is14_sel = res_mode == M14;
            run(is14_sel, &r, &cwd_app);
        } else {
            bool first14 = res_mode == M14A;
            run(first14, &r, &cwd_app);
            is14_sel = first14;
            if (r.stage == STG_BAD_BLOCK) {
                BlockResult r2;
                bool ca2 = false;
                run(!first14, &r2, &ca2);
                if (r2.stage != STG_BAD_BLOCK) {
                    r = r2;
                    cwd_app = ca2;
                    is14_sel = !first14;
                }
            }
        }

        const int lim = is14_sel ? 8 : 7;
        const bool broken = r.state == AUD_BROKEN;
        bool block_valid = true;
        for (int i = 0; i < 6; ++i) block_valid = block_valid && r.valid[i];
        int raw_errs = 0;
        for (int i = 0; i < lim; ++i)
            raw_errs += (!r.lcrc[i]) && !cwd_b[i];
        const bool can_force =
            !broken && (is14_sel ? raw_errs <= 1 : raw_errs == 0);
        bool silent = true;
        for (int i = 0; i < 6; ++i) {
            int16_t s;
            if (is14_sel) {
                s = expand14(r.w[i], m2);
            } else {
                int32_t v = r.w[i] & 0xFFFF;
                if (v >= 0x8000) v -= 0x10000;
                s = (int16_t)v;
            }
            if (samples_out) samples_out[b * 6 + i] = s;
            if (s != 0) silent = false;
        }
        uint8_t flags = 0;
        if (broken) flags |= 1;
        if (block_valid) flags |= 2;
        if (can_force) flags |= 4;
        if (silent) flags |= 8;
        if (r.state == AUD_FIX_P) flags |= 16;
        if (r.state == AUD_FIX_Q) flags |= 32;
        if (cwd_app) flags |= 64;
        flags_out[b] = flags;
        // Each block output is individually optional (NULL -> skip):
        // the seam-stat path reads flags alone, the fused deinterleave
        // path needs valid/lcrc/res but never the i64 words.
        if (words_out) {
            for (int i = 0; i < 8; ++i)
                words_out[b * 8 + i] = r.w[i];
        }
        if (valid_out) {
            for (int i = 0; i < 8; ++i) {
                valid_out[b * 8 + i] = r.valid[i];
                lcrc_out[b * 8 + i] = r.lcrc[i];
            }
        }
        if (state_out) {
            state_out[b] = r.state;
            stage_out[b] = r.stage;
        }
        if (res_out) res_out[b] = is14_sel ? 0 : 1;
    }
    return 0;
}

int32_t stc007_finalize_blocks(
    const uint8_t* flags, const uint8_t* valid, const uint8_t* lcrc,
    const int32_t* resolution, const int64_t* rows,
    const int64_t* line_number, const int64_t* frame_number, int64_t B,
    int64_t start, int32_t inner_gate, int32_t outer_gate,
    int64_t fa_frame, int64_t f0_frame, int64_t fb_frame,
    int32_t broken_mask_dur, int32_t countdown_in,
    int32_t file_start, int32_t file_end,
    uint8_t* out_valid, uint8_t* wvalid, uint8_t* wfixed,
    uint8_t* bvalid_out, uint8_t* mask_out, int64_t* counters);

// Fused performDeinterleave: eval_rows (contiguous shifts) straight
// into finalize_blocks with the intermediate per-block arrays held in
// thread-local scratch — one Python->C call per frame, and the unused
// i64 block words are never materialized.  Outputs are exactly the
// SampleChunk ingredients plus the stats counters.  Returns the new
// BROKEN countdown, or a negative eval error.
int64_t stc007_deint_finalize(
    const int32_t* line_words, const uint8_t* line_crc,
    const uint8_t* cwd_line, int64_t start, int64_t B,
    int32_t res_mode, int32_t en_p, int32_t en_q, int32_t force_ecc,
    int32_t en_cwd, int32_t m2,
    const int64_t* line_number, const int64_t* frame_number,
    int32_t inner_gate, int32_t outer_gate,
    int64_t fa_frame, int64_t f0_frame, int64_t fb_frame,
    int32_t broken_mask_dur, int32_t countdown_in,
    int32_t file_start, int32_t file_end,
    int16_t* samples_out, uint8_t* wvalid, uint8_t* wfixed,
    uint8_t* bvalid_out, int64_t* counters) {
    thread_local std::vector<uint8_t> valid, lcrc, flags, ovalid, mask;
    thread_local std::vector<int32_t> res;
    if ((int64_t)valid.size() < B * 8) {
        valid.resize((size_t)B * 8);
        lcrc.resize((size_t)B * 8);
        ovalid.resize((size_t)B * 8);
    }
    if ((int64_t)flags.size() < B) {
        flags.resize((size_t)B);
        mask.resize((size_t)B);
        res.resize((size_t)B);
    }
    int rc = stc007_eval_rows(line_words, line_crc, cwd_line, nullptr,
                              start, B, res_mode, en_p, en_q, force_ecc,
                              en_cwd, m2, nullptr, valid.data(),
                              lcrc.data(), nullptr, nullptr, res.data(),
                              flags.data(), samples_out);
    if (rc != 0) return rc;
    return stc007_finalize_blocks(
        flags.data(), valid.data(), lcrc.data(), res.data(), nullptr,
        line_number, frame_number, B, start, inner_gate, outer_gate,
        fa_frame, f0_frame, fb_frame, broken_mask_dur, countdown_in,
        file_start, file_end, ovalid.data(), wvalid, wfixed,
        bvalid_out, mask.data(), counters);
}

// Seam eval without queue assembly — the steady-state tryPadding path
// (tryPadding stc007datastitcher.cpp:1417-1743).  The seam queue
// [field1 tail | padding | field2 head] is gathered HERE from the two
// field stores' cached int32/crc8 buffers plus an implicit silent pad,
// instead of concatenating 5+ numpy arrays per call on the Python side.
// Only the burst stats are exported (valid/silent/unchecked runs +
// broken count): they are all tryPadding reads — the block words are
// re-derived by the final deinterleave.  Returns 1 when the queue is
// too short (DS_RET_NO_DATA), negative on table error.
void stc007_burst_stats(const uint8_t* flags, int64_t B, int32_t unch_lim,
                        int32_t en_q, int32_t max_burst_silence,
                        int32_t max_burst_broken, int32_t* out);

int stc007_eval_seam(
    const int32_t* a_words, const uint8_t* a_crc, int64_t a_n,
    int64_t pad_n, const int32_t* pad_words,
    const int32_t* c_words, const uint8_t* c_crc, int64_t c_n,
    int32_t res_mode, int32_t en_p, int32_t en_q, int32_t force_ecc,
    int32_t m2, int32_t unch_lim, int32_t max_burst_silence,
    int32_t max_burst_broken, int32_t* stats_out) {
    const int64_t L = a_n + pad_n + c_n;
    const int64_t B = L - 112;  // MIN_DEINT_DATA
    if (B <= 0) return 1;
    // Steady state calls this twice per frame: growable thread-local
    // scratch instead of fresh vectors per call.
    thread_local std::vector<int32_t> w;
    thread_local std::vector<uint8_t> c;
    thread_local std::vector<uint8_t> flags;
    if ((int64_t)w.size() < L * 8) w.resize((size_t)L * 8);
    if ((int64_t)c.size() < L * 8) c.resize((size_t)L * 8);
    if ((int64_t)flags.size() < B) flags.resize((size_t)B);
    if (a_n) {
        memcpy(w.data(), a_words, (size_t)a_n * 8 * sizeof(int32_t));
        memcpy(c.data(), a_crc, (size_t)a_n * 8);
    }
    for (int64_t i = 0; i < pad_n; ++i)
        memcpy(&w[(size_t)(a_n + i) * 8], pad_words, 8 * sizeof(int32_t));
    // pad rows: CRC all-invalid (LineStore.empty_lines semantics)
    if (pad_n) memset(&c[(size_t)a_n * 8], 0, (size_t)pad_n * 8);
    if (c_n) {
        memcpy(&w[(size_t)(a_n + pad_n) * 8], c_words,
               (size_t)c_n * 8 * sizeof(int32_t));
        memcpy(&c[(size_t)(a_n + pad_n) * 8], c_crc, (size_t)c_n * 8);
    }
    int rc = stc007_eval_rows(w.data(), c.data(), nullptr, nullptr, 0, B,
                              res_mode, en_p, en_q, force_ecc, 0, m2,
                              nullptr, nullptr, nullptr,
                              nullptr, nullptr, nullptr,
                              flags.data(), nullptr);
    if (rc != 0) return rc;
    stc007_burst_stats(flags.data(), B, unch_lim, en_q,
                       max_burst_silence, max_burst_broken, stats_out);
    return 0;
}

void stc007_field_res_counts(const int32_t* line_words,
                             const uint8_t* line_crc, int64_t L,
                             int64_t test_size, int32_t m2,
                             int64_t* c14, int64_t* c16);

// ---------------------------------------------------------------------------
// Steady-state pair tail: the whole computational load of a
// TRY_PREVIOUS -> TRY_xFF -> PAD_OK frame (findFieldStitching
// stc007datastitcher.cpp:2929 fast path + fillFrameForOutput :4588 +
// performDeinterleave :6675) in ONE call.  Python keeps every state
// transition (frasm flags, 65-deep stats, frame log) and falls back to
// the full stage machine whenever this returns a bail code — so the
// fast path can only ever match the slow path bit-for-bit or defer.
// ---------------------------------------------------------------------------
namespace {
// getResolutionModeForSeam (stc007datastitcher.cpp:1214-1256; twin of
// stitcher_stc007.resolution_mode_for_seam).
inline int res_mode_combine(int r1, int r2) {
    if (r1 == r2) {
        if (r1 == M14A) return M14;
        if (r1 == M16A) return M16;
        return r1;
    }
    if (r1 == M14 && r2 == M14A) return M14A;
    if (r1 == M14A && r2 == M14) return M14A;
    if (r1 == M16 && r2 == M14) return M14A;
    return M16A;
}

// getFieldResolution's counts->resolution rule (:996-1214).
// 0 = unknown, 14, 16.
inline int res_from_counts(int64_t c14, int64_t c16) {
    if (c14 > 2 * 16) {  // INTERLEAVE_OFS * 2
        return (c16 * 128 / c14) > 32 ? 16 : 14;
    }
    return 0;
}

// _stats_verdict == DS_RET_OK (stats = valid,silent,unchecked,broken).
inline bool seam_ok(const int32_t* s, int32_t unch_lim,
                    int32_t max_burst_silence, int32_t max_burst_broken) {
    if (s[3] >= max_burst_broken) return false;
    if (s[1] > max_burst_silence) return false;
    if (s[2] > unch_lim) return false;
    return s[0] != 0;
}
}  // namespace

// Inputs: the conv carry, the two frame-A assembly fields (in f0 field
// order; full length for the seams, capped count for assembly), frame
// B's leading field (outer seam), the two fresh frame-B fields for
// resolution counting, and the silent-pad word pattern.
// outer_full_mode >= 0 means the outer seam's last block row lands on
// the frame-A side and Python resolved the mode; -1 means it lands in
// frame B and the mode combines with the fresh field resolution of
// parity `outer_last_is_even` (detectAudioResolution's known-frame-A
// branch, :2207-2773).
// Outputs: res_counts [4] (c14/c16 for odd then even fresh field),
// seam_stats [8] (inner then outer: valid,silent,unch,broken), and the
// deint outputs over B = n0+c1+pad_inner+c2+pad_outer-112 blocks.
// Returns the new BROKEN countdown (>= 0), or -2 when the inner seam
// verdict is not OK, -3 for the outer seam, -1 on table error (deint
// outputs untouched on any negative return; res counts always valid).
int64_t stc007_steady_tail(
    const int32_t* carry_w, const uint8_t* carry_c, int64_t n0,
    const int32_t* f1a_w, const uint8_t* f1a_c, int64_t f1a_n, int64_t c1,
    const int32_t* f1b_w, const uint8_t* f1b_c, int64_t f1b_n, int64_t c2,
    const int32_t* f2f_w, const uint8_t* f2f_c, int64_t f2f_n,
    const int32_t* ra_w, const uint8_t* ra_c, int64_t ra_n,
    const int32_t* rb_w, const uint8_t* rb_c, int64_t rb_n,
    const int32_t* silent_w, int64_t pad_inner, int64_t pad_outer,
    int32_t inner_res_mode, int32_t outer_first_mode,
    int32_t outer_full_mode, int32_t outer_last_is_even,
    int32_t fb_unk_mode, int32_t en_p, int32_t en_q, int32_t m2,
    int32_t unch_lim, int32_t max_burst_silence, int32_t max_burst_broken,
    int32_t conv_res_mode, int32_t broken_mask_dur, int32_t countdown_in,
    int64_t* res_counts, int32_t* seam_stats,
    int16_t* samples, uint8_t* wvalid, uint8_t* wfixed, uint8_t* bvalid,
    int64_t* counters) {
    // 1. Fresh-field resolution counts (always computed: the Python
    // side caches them on the field objects even when a seam bails,
    // so the slow path never re-evaluates).
    res_counts[0] = res_counts[1] = res_counts[2] = res_counts[3] = 0;
    // M2 never consults the counts (every mode is fixed 14-bit).
    if (!m2 && ra_n > 112)
        stc007_field_res_counts(ra_w, ra_c, ra_n, ra_n - 112, m2,
                                &res_counts[0], &res_counts[1]);
    if (!m2 && rb_n > 112)
        stc007_field_res_counts(rb_w, rb_c, rb_n, rb_n - 112, m2,
                                &res_counts[2], &res_counts[3]);

    // 2. Inner seam (tryPadding(field1, field2, f0.inner_padding)).
    const int64_t keep = 120;  // MIN_DEINT_DATA + INTERLEAVE_OFS/2
    {
        const int64_t start1 = std::max<int64_t>(0, f1a_n
                                                 - (keep - pad_inner));
        const int64_t count2 = std::min(f1b_n, keep);
        int rc = stc007_eval_seam(
            f1a_w + start1 * 8, f1a_c + start1 * 8, f1a_n - start1,
            pad_inner, silent_w, f1b_w, f1b_c, count2,
            inner_res_mode, en_p, en_q, 1, m2, unch_lim,
            max_burst_silence, max_burst_broken, seam_stats);
        if (rc != 0) return -2;
        if (!seam_ok(seam_stats, unch_lim, max_burst_silence,
                     max_burst_broken))
            return -2;
    }

    // 3. Outer seam mode: combine with the fresh field's resolution
    // when the last block row lands in frame B.
    int32_t outer_mode = outer_full_mode;
    if (outer_mode < 0) {
        const int ra = res_from_counts(res_counts[0], res_counts[1]);
        const int rb = res_from_counts(res_counts[2], res_counts[3]);
        int fb_odd, fb_even;  // detectAudioResolution else-branch
        if (ra == 0 && rb == 0) {
            fb_odd = fb_even = fb_unk_mode;
        } else if (ra == 0) {
            fb_even = rb == 16 ? M16 : M14;
            fb_odd = rb == 16 ? M16A : M14A;
        } else if (rb == 0) {
            fb_odd = ra == 16 ? M16 : M14;
            fb_even = ra == 16 ? M16A : M14A;
        } else {
            fb_odd = ra == 16 ? M16 : M14;
            fb_even = rb == 16 ? M16 : M14;
        }
        const int fb_side = outer_last_is_even ? fb_even : fb_odd;
        outer_mode = res_mode_combine(outer_first_mode, fb_side);
    }

    // 4. Outer seam (tryPadding(field2, f2_first, f0.outer_padding)).
    {
        const int64_t start1 = std::max<int64_t>(0, f1b_n
                                                 - (keep - pad_outer));
        const int64_t count2 = std::min(f2f_n, keep);
        int rc = stc007_eval_seam(
            f1b_w + start1 * 8, f1b_c + start1 * 8, f1b_n - start1,
            pad_outer, silent_w, f2f_w, f2f_c, count2,
            outer_mode, en_p, en_q, 1, m2, unch_lim,
            max_burst_silence, max_burst_broken, seam_stats + 4);
        if (rc != 0) return -3;
        if (!seam_ok(seam_stats + 4, unch_lim, max_burst_silence,
                     max_burst_broken))
            return -3;
    }

    // 5. Assemble conv = [carry | field1 | padI | field2 | padO] into
    // scratch (words + crc only: with the seam gates and file flags
    // off, the finalize pass never reads line/frame numbers) and run
    // the fused deinterleave.
    const int64_t L = n0 + c1 + pad_inner + c2 + pad_outer;
    const int64_t B = L - 112;
    if (B <= 0) return -4;
    thread_local std::vector<int32_t> w;
    thread_local std::vector<uint8_t> c;
    if ((int64_t)w.size() < L * 8) w.resize((size_t)L * 8);
    if ((int64_t)c.size() < L * 8) c.resize((size_t)L * 8);
    int64_t pos = 0;
    auto put = [&](const int32_t* sw, const uint8_t* sc, int64_t n) {
        if (!n) return;
        memcpy(&w[(size_t)pos * 8], sw, (size_t)n * 8 * sizeof(int32_t));
        memcpy(&c[(size_t)pos * 8], sc, (size_t)n * 8);
        pos += n;
    };
    auto put_pad = [&](int64_t n) {
        for (int64_t i = 0; i < n; ++i)
            memcpy(&w[(size_t)(pos + i) * 8], silent_w,
                   8 * sizeof(int32_t));
        if (n) memset(&c[(size_t)pos * 8], 0, (size_t)n * 8);
        pos += n;
    };
    put(carry_w, carry_c, n0);
    put(f1a_w, f1a_c, c1);
    put_pad(pad_inner);
    put(f1b_w, f1b_c, c2);
    put_pad(pad_outer);
    return stc007_deint_finalize(
        w.data(), c.data(), nullptr, 0, B, conv_res_mode, en_p, en_q,
        1, 0, m2, nullptr, nullptr, 0, 0, 0, 0, 0,
        broken_mask_dur, countdown_in, 0, 0,
        samples, wvalid, wfixed, bvalid, counters);
}

// All-paddings seam sweep (findPadding stc007datastitcher.cpp:1743):
// one eval_seam per padding, looped C-side.  modes[p] is the seam's
// resolution mode (or -1: queue too short -> no stats).  stats_out
// [P,4] = (valid, silent, unchecked, broken); has_stats [P] u8.
void stc007_padding_sweep(
    const int32_t* f1_w, const uint8_t* f1_c, int64_t f1_n,
    const int32_t* f2_w, const uint8_t* f2_c, int64_t f2_n,
    const int32_t* silent_w, int64_t max_padding, const int32_t* modes,
    int32_t en_p, int32_t en_q, int32_t m2, int32_t unch_lim,
    int32_t max_burst_silence, int32_t max_burst_broken,
    int32_t* stats_out, uint8_t* has_stats) {
    const int64_t keep = 120;  // MIN_DEINT_DATA + INTERLEAVE_OFS/2
    for (int64_t p = 0; p < max_padding; ++p) {
        has_stats[p] = 0;
        if (modes[p] < 0) continue;
        const int64_t start1 = std::max<int64_t>(0, f1_n - (keep - p));
        const int64_t count2 = std::min(f2_n, keep);
        int rc = stc007_eval_seam(
            f1_w + start1 * 8, f1_c + start1 * 8, f1_n - start1,
            p, silent_w, f2_w, f2_c, count2, modes[p], en_p, en_q, 1,
            m2, unch_lim, max_burst_silence, max_burst_broken,
            stats_out + p * 4);
        has_stats[p] = rc == 0;
    }
}

void stc007_trim_scan(
    const int64_t* line_number, const int64_t* frame_number,
    const int8_t* service, const uint8_t* crcv, const uint8_t* forced_bad,
    const uint8_t* has_markers, int64_t L, int64_t frame_no,
    int32_t rule_b_or_crc, int64_t* out);
void stc007_split_scan(
    const int64_t* line_number, const int64_t* frame_number,
    const int8_t* service, const uint8_t* crcv, const uint8_t* forced_bad,
    int64_t L, int64_t frame_no,
    int64_t even_top, int64_t even_bottom, int64_t even_enable,
    int64_t odd_top, int64_t odd_bottom, int64_t odd_enable,
    int64_t cap, int64_t* out,
    int64_t* idx_even_out, int64_t* idx_odd_out);

// ---------------------------------------------------------------------------
// Steady-state ROUND: process as many consecutive TRY_PREVIOUS frames
// as possible in one call — per pair: frame-B trim scan, field split,
// fresh-field resolution counts, both seam evals, conv assembly and the
// fused deinterleave, with the frame-A facts, the f0 snapshot, the
// conv carry and the rolling resolutions all carried C-side.  The
// stitcher replays the stage machine's state transitions from the
// per-pair records; the first non-steady pair stops the run (its
// record still carries the trim scan so Python's fallback reuses it).
// ---------------------------------------------------------------------------
uint16_t stc007_crc_row(const int32_t* w8);  // defined below (C linkage)

namespace {
// Per-frame pointer-table entries (int64 each, FP_N per frame):
enum { FP_WORDS, FP_WORD_CRC, FP_FORCED, FP_LN, FP_FN, FP_SVC, FP_CRCV,
       FP_REF, FP_MARK, FP_LEN, FP_FRNO, FP_SRC, FP_WVALID, FP_COORDV,
       FP_N };
// Rolling state vector (int64), in/out:
enum { ST_F0_ODD_DATA, ST_F0_EVEN_DATA, ST_F0_INNER_PAD, ST_F0_OUTER_PAD,
       ST_F0_INNER_OK, ST_F0_OUTER_OK, ST_F0_ORDER, ST_F0_VID_STD,
       ST_F0_FRNO, ST_F0_ODD_MODE, ST_F0_EVEN_MODE,
       ST_FA_FRNO, ST_FA_TRIM_OK, ST_FA_ETOP, ST_FA_EBOT, ST_FA_OTOP,
       ST_FA_OBOT, ST_RES1O, ST_RES1E, ST_FA_ORDER, ST_FA_NEW, ST_FA_END,
       ST_COUNTDOWN, ST_N };
// Per-pair record layout (int64[REC_N]):
enum { RC_STATUS, RC_NEW, RC_END, RC_CB, RC_TRIM /*14*/,
       RC_SPLIT = RC_TRIM + 14 /*13*/, RC_OREF = RC_SPLIT + 13, RC_EREF,
       RC_RES /*4*/, RC_VSTD = RC_RES + 4, RC_TARGET,
       RC_CNT /*6*/, RC_CD = RC_CNT + 6, RC_NBLK, RC_OFS, RC_N };
// bail statuses
enum { BS_OK = 0, BS_FILE = 1, BS_CB_AUTO_M2 = 2, BS_SPLIT = 3,
       BS_TRY = 4, BS_RES_UNK = 5, BS_FIT = 6, BS_SEAM_IN = 7,
       BS_SEAM_OUT = 8, BS_CONV = 9, BS_ERR = 10 };
constexpr int64_t KEEP = 120;          // MIN_DEINT_DATA + ILV/2
constexpr int64_t MDD = 112;           // MIN_DEINT_DATA
constexpr int64_t LPF_PAL = 294, LPF_NTSC = 245, LPF_DEFAULT = 245;
constexpr int64_t LPF_MAX_PAL = LPF_PAL + 16;
constexpr int64_t LPF_MAX_NTSC = LPF_PAL - 32;
constexpr int64_t MIN_FILL = 56;       // MIN_DEINT_DATA // 2
constexpr int64_t MIN_GOOD = LPF_DEFAULT - 8;
constexpr int ORD_UNK = 0, ORD_TFF = 1, ORD_BFF = 2;
constexpr int VID_UNK = 0, VID_PAL_C = 1, VID_NTSC_C = 2;

struct FieldBuf {
    std::vector<int32_t> w;
    std::vector<uint8_t> c;
    std::vector<int64_t> ln;
    // Full per-row store state (filled only when `full` — the CWD
    // write-back fixpoint needs it; seam/deint evals only need w/c).
    std::vector<int64_t> src;
    std::vector<uint8_t> wc9, wv9, fb, cv;
    int64_t n = 0;
    int parity = 0;  // 0 even, 1 odd
    void fill(const int64_t* fp, int64_t first, int64_t step,
              int64_t count, bool full = false) {
        n = count;
        if ((int64_t)w.size() < count * 8) {
            w.resize((size_t)count * 8);
            c.resize((size_t)count * 8);
            ln.resize((size_t)count);
        }
        if (full && (int64_t)src.size() < count) {
            src.resize((size_t)count);
            wc9.resize((size_t)count * 9);
            wv9.resize((size_t)count * 9);
            fb.resize((size_t)count);
            cv.resize((size_t)count);
        }
        const int64_t* words = (const int64_t*)fp[FP_WORDS];
        const uint8_t* wcrc = (const uint8_t*)fp[FP_WORD_CRC];
        const uint8_t* forced = (const uint8_t*)fp[FP_FORCED];
        const int64_t* lna = (const int64_t*)fp[FP_LN];
        const int64_t* srca = (const int64_t*)fp[FP_SRC];
        const uint8_t* wva = (const uint8_t*)fp[FP_WVALID];
        const uint8_t* cva = (const uint8_t*)fp[FP_COORDV];
        for (int64_t k = 0; k < count; ++k) {
            const int64_t r = first + k * step;
            const uint8_t fbk = forced[r];
            for (int i = 0; i < 8; ++i) {
                w[k * 8 + i] = (int32_t)words[r * 8 + i];
                c[k * 8 + i] = wcrc[r * 9 + i] && !fbk;
            }
            ln[k] = lna[r];
            if (full) {
                src[k] = srca[r];
                for (int i = 0; i < 9; ++i) {
                    wc9[k * 9 + i] = wcrc[r * 9 + i];
                    wv9[k * 9 + i] = wva[r * 9 + i];
                }
                fb[k] = fbk;
                cv[k] = cva[r];
            }
        }
        parity = count ? (int)(ln[0] & 1) : 0;
    }
};

// performCWD write-back fixpoint over the assembled conv queue
// (+ the appended head of frame B's leading field), mutating words /
// word_valid / forced / source CRC / crc_ok in place — the exact
// transcription of stitcher_stc007.perform_cwd / prescan_frame
// (reference performCWD stc007datastitcher.cpp:5905, prescanFrame
// :6401, patchBrokenLines :5459), including the Python port's cache
// semantics: crc_ok (cc) refreshes only after an iteration that WROTE
// words, and an iteration that only marks false-positive lines ends
// the loop (fixes == 0) with cc untouched.
// crcv[r] (crc_valid_ignore_forced) must arrive recomputed as
// crc_row(words)==src; it is updated incrementally on writes.
// Returns the final per-row CWD flags for the deint in cwdline.
inline void stc007_cwd_fixpoint(
    int32_t* cw, uint8_t* cc, int64_t* csrc, uint8_t* cwc, uint8_t* cwv,
    uint8_t* cfb, const uint8_t* ccv, uint8_t* crcv, const int64_t* cfn,
    int64_t L, int64_t fb_frno, int conv_mode, int en_p, int en_q,
    int m2, std::vector<uint8_t>& cwdline) {
    const int64_t B = L - MDD;
    if (B <= 0) {
        if ((int64_t)cwdline.size() < (L > 0 ? L : 1))
            cwdline.resize((size_t)(L > 0 ? L : 1));
        for (int64_t r = 0; r < L; ++r) cwdline[r] = 0;
        return;
    }
    thread_local std::vector<int64_t> bw;
    thread_local std::vector<uint8_t> bval, blcrc, bflags;
    thread_local std::vector<int32_t> bres;
    thread_local std::vector<int16_t> bsamp;
    if ((int64_t)bval.size() < B * 8) {
        bw.resize((size_t)B * 8);
        bval.resize((size_t)B * 8);
        blcrc.resize((size_t)B * 8);
        bflags.resize((size_t)B);
        bres.resize((size_t)B);
        bsamp.resize((size_t)B * 6);
    }
    if ((int64_t)cwdline.size() < L) cwdline.resize((size_t)L);
    auto refresh_cwdline = [&]() {
        for (int64_t r = 0; r < L; ++r) {
            uint8_t any = 0;
            for (int i = 0; i < 9 && !any; ++i)
                any = !cwc[r * 9 + i] && cwv[r * 9 + i];
            cwdline[r] = (!cfb[r] && crcv[r] && any) ? 1 : 0;
        }
    };
    for (int iter = 0; iter < 16; ++iter) {
        refresh_cwdline();
        if (stc007_eval_rows(cw, cc, cwdline.data(), nullptr, 0, B,
                             conv_mode, en_p, en_q, 1, 1, m2,
                             bw.data(), bval.data(), blcrc.data(),
                             nullptr, nullptr, bres.data(),
                             bflags.data(), bsamp.data()) != 0)
            break;
        int64_t fixes = 0;
        bool wrote = false;
        for (int64_t b = 0; b < B; ++b) {
            const uint8_t f = bflags[b];
            if (!(f & 2) || !(f & (16 | 32))) continue;
            const bool is16 = bres[b] != 0;
            const int max_fix = (!en_q || is16) ? 6 : 7;
            for (int w = 0; w <= max_fix; ++w) {
                if (blcrc[b * 8 + w]) continue;
                const int64_t row = b + (int64_t)w * 16;
                if (!crcv[row] && ccv[row] && !cfb[row]
                        && cfn[row] != fb_frno) {
                    int32_t* rw = &cw[row * 8];
                    if (!is16) {
                        const int32_t nw = (int32_t)bw[b * 8 + w];
                        if (rw[w] != nw) rw[w] = nw;
                        cwv[row * 9 + w] = 1;
                        uint16_t rc = stc007_crc_row(rw);
                        if (rc == (uint16_t)(csrc[row] & 0xFFFF)) {
                            for (int i = 0; i < 9; ++i)
                                cwv[row * 9 + i] = 1;
                            ++fixes;
                        } else {
                            bool all8 = true;
                            for (int i = 0; i < 8; ++i)
                                all8 = all8 && cwv[row * 9 + i];
                            if (all8) {
                                // dropout on the CRC word itself
                                csrc[row] = rc;
                                cwv[row * 9 + 8] = 1;
                                ++fixes;
                            }
                        }
                        wrote = true;
                        crcv[row] = stc007_crc_row(rw)
                            == (uint16_t)(csrc[row] & 0xFFFF);
                    } else {
                        const int64_t full = bw[b * 8 + w];
                        const int32_t nw = (int32_t)(full >> F1_WORD_OFS);
                        const int32_t s_bits = (int32_t)(full & F1_S_MASK);
                        const int ofs = F1_S_OFFSETS[w];
                        if (rw[w] != nw) {
                            rw[w] = nw;
                            cwv[row * 9 + w] = 1;
                        }
                        if (stc007_crc_row(rw)
                                != (uint16_t)(csrc[row] & 0xFFFF)) {
                            const int32_t old_s = rw[7];
                            rw[7] = (old_s & ~(F1_S_MASK << ofs))
                                  | (s_bits << ofs);
                        }
                        if (stc007_crc_row(rw)
                                == (uint16_t)(csrc[row] & 0xFFFF)) {
                            for (int i = 0; i < 9; ++i)
                                cwv[row * 9 + i] = 1;
                            ++fixes;
                        }
                        wrote = true;
                        crcv[row] = stc007_crc_row(rw)
                            == (uint16_t)(csrc[row] & 0xFFFF);
                    }
                } else {
                    // False-positive valid line feeding a fixed block:
                    // its word disagrees with the corrected one
                    // (performCWD :6313-6334).
                    if (crcv[row] && !cfb[row] && !is16
                            && cw[row * 8 + w] != (int32_t)bw[b * 8 + w])
                        cfb[row] = 1;
                }
            }
        }
        if (wrote) {
            // invalidate_crc() analog: crc_ok recomputes from the
            // CURRENT word_crc & !forced on the next access.
            for (int64_t r = 0; r < L; ++r)
                for (int i = 0; i < 8; ++i)
                    cc[r * 8 + i] = cwc[r * 9 + i] && !cfb[r];
        }
        if (fixes == 0) break;
    }
    // The deint's cwd_line is computed fresh from the final state.
    refresh_cwdline();
}
}  // namespace

// Returns the number of steady pairs completed (records[0..k-1] have
// status BS_OK; record k, when k < n_pairs, carries the bail status and
// whatever was computed before the bail).  `frames` is the int64
// pointer table ([n_frames, FP_N]); `state` is the rolling state vector
// (updated in place to the post-run values); outputs are offset-packed.
int64_t stc007_steady_round(
    const int64_t* frames, int64_t n_frames,
    const int32_t* carry_w_in, const uint8_t* carry_c_in,
    const int64_t* carry_ln_in, const int64_t* carry_fn_in, int64_t n0_in,
    const int32_t* silent_w,
    int32_t en_p, int32_t en_q, int32_t unch_lim,
    int32_t max_burst_silence, int32_t max_burst_broken,
    int32_t broken_mask_dur, int32_t auto_m2, int32_t m2,
    int32_t fixed_mode,
    int32_t preset_order, int32_t preset_vid, int32_t fa_order_preset,
    int32_t en_cwd,
    const int64_t* carry_src_in, const uint8_t* carry_wc9_in,
    const uint8_t* carry_wv9_in, const uint8_t* carry_fb_in,
    const uint8_t* carry_cv_in,
    int32_t* carry_w_out, int64_t* carry_src_out,
    uint8_t* carry_wc9_out, uint8_t* carry_wv9_out,
    uint8_t* carry_fb_out, uint8_t* carry_cv_out,
    int64_t* carry_ln_out, int64_t* carry_fn_out, int64_t* carry_n_out,
    int64_t* state, int64_t* records,
    int16_t* samples, uint8_t* wvalid, uint8_t* wfixed, uint8_t* bvalid) {
    const int64_t n_pairs = n_frames - 1;
    if (n_pairs <= 0 || !g_tables_set) return 0;

    // conv / carry scratch (words+crc for eval, ln/fn for the roll;
    // under en_cwd also the full per-row store state the write-back
    // fixpoint mutates).  Capacity covers the CWD prescan extension
    // (+MDD rows of frame B's leading field).
    thread_local std::vector<int32_t> cw;
    thread_local std::vector<uint8_t> cc;
    thread_local std::vector<int64_t> cln, cfn;
    thread_local std::vector<int64_t> csrc;
    thread_local std::vector<uint8_t> cwc, cwv, cfb, ccv, ccrcv, cwdline;
    thread_local FieldBuf fld_e, fld_o, f2f_buf;
    const int64_t conv_cap = 2 * MDD + 2 * LPF_PAL + 8;
    if ((int64_t)cw.size() < conv_cap * 8) {
        cw.resize((size_t)conv_cap * 8);
        cc.resize((size_t)conv_cap * 8);
        cln.resize((size_t)conv_cap);
        cfn.resize((size_t)conv_cap);
    }
    if (en_cwd && (int64_t)csrc.size() < conv_cap) {
        csrc.resize((size_t)conv_cap);
        cwc.resize((size_t)conv_cap * 9);
        cwv.resize((size_t)conv_cap * 9);
        cfb.resize((size_t)conv_cap);
        ccv.resize((size_t)conv_cap);
        ccrcv.resize((size_t)conv_cap);
    }
    int64_t n0 = n0_in;
    if (n0 > MDD) return 0;  // steady carry is never longer than MDD
    if (n0) {
        memcpy(cw.data(), carry_w_in, (size_t)n0 * 8 * sizeof(int32_t));
        memcpy(cc.data(), carry_c_in, (size_t)n0 * 8);
        memcpy(cln.data(), carry_ln_in, (size_t)n0 * sizeof(int64_t));
        memcpy(cfn.data(), carry_fn_in, (size_t)n0 * sizeof(int64_t));
        if (en_cwd) {
            memcpy(csrc.data(), carry_src_in,
                   (size_t)n0 * sizeof(int64_t));
            memcpy(cwc.data(), carry_wc9_in, (size_t)n0 * 9);
            memcpy(cwv.data(), carry_wv9_in, (size_t)n0 * 9);
            memcpy(cfb.data(), carry_fb_in, (size_t)n0);
            memcpy(ccv.data(), carry_cv_in, (size_t)n0);
        }
    }
    // empty_lines pad rows: silent words, complement-silent source CRC.
    const int64_t pad_src = (~(int64_t)stc007_crc_row(silent_w)) & 0xFFFF;
    // The final carry (post-roll, incl. CWD mutations) exports at every
    // return so Python rebuilds conv_queue exactly.
    auto export_carry = [&]() {
        if (!en_cwd || !carry_w_out) return;
        *carry_n_out = n0;
        memcpy(carry_w_out, cw.data(), (size_t)n0 * 8 * sizeof(int32_t));
        memcpy(carry_src_out, csrc.data(), (size_t)n0 * sizeof(int64_t));
        memcpy(carry_wc9_out, cwc.data(), (size_t)n0 * 9);
        memcpy(carry_wv9_out, cwv.data(), (size_t)n0 * 9);
        memcpy(carry_fb_out, cfb.data(), (size_t)n0);
        memcpy(carry_cv_out, ccv.data(), (size_t)n0);
        memcpy(carry_ln_out, cln.data(), (size_t)n0 * sizeof(int64_t));
        memcpy(carry_fn_out, cfn.data(), (size_t)n0 * sizeof(int64_t));
    };
    int64_t out_ofs = 0;
    int64_t f1_max_line = -1;  // recomputed on pair 0 from the f1 split

    int64_t pair = 0;
    for (; pair < n_pairs; ++pair) {
        int64_t* rec = records + pair * RC_N;
        for (int i = 0; i < RC_N; ++i) rec[i] = 0;
        rec[RC_CB] = -1;
        const int64_t* f1p = frames + pair * FP_N;
        const int64_t* f2p = frames + (pair + 1) * FP_N;
        const int64_t fa_frno = f1p[FP_FRNO];
        const int64_t fb_frno = f2p[FP_FRNO];
        if (fa_frno == fb_frno || fa_frno == state[ST_F0_FRNO]) {
            rec[RC_STATUS] = BS_CONV;
            rec[RC_CB] = -2;  // no trim scan ran: replay must not cache
            break;
        }
        // --- frame B trim scan (find_frames_trim) ---
        int64_t tb[14];
        stc007_trim_scan((const int64_t*)f2p[FP_LN],
                         (const int64_t*)f2p[FP_FN],
                         (const int8_t*)f2p[FP_SVC],
                         (const uint8_t*)f2p[FP_CRCV],
                         (const uint8_t*)f2p[FP_FORCED],
                         (const uint8_t*)f2p[FP_MARK],
                         f2p[FP_LEN], fb_frno, 1, tb);
        for (int i = 0; i < 14; ++i) rec[RC_TRIM + i] = tb[i];
        rec[RC_NEW] = tb[8];
        rec[RC_END] = tb[9];
        const bool cb_hit = tb[10] >= 0 && (tb[11] < 0 || tb[10] < tb[11]);
        rec[RC_CB] = cb_hit ? tb[10] : -1;
        if (state[ST_FA_NEW] || state[ST_FA_END] || tb[8] || tb[9]) {
            rec[RC_STATUS] = BS_FILE;
            break;
        }
        if (cb_hit && auto_m2) {
            rec[RC_STATUS] = BS_CB_AUTO_M2;
            break;
        }
        // frame B trim facts (skip-bad rule per parity).
        const int64_t* lnb = (const int64_t*)f2p[FP_LN];
        int64_t fb_top[2] = {0, 0}, fb_bot[2] = {0, 0};  // [even, odd]
        bool fb_found[2] = {false, false};
        for (int p = 0; p < 2; ++p) {
            const int base = p == 0 ? 0 : 4;
            const int good = p == 0 ? 12 : 13;
            const int o = tb[good] > MIN_GOOD ? base : base + 2;
            if (tb[o] >= 0) {
                fb_found[p] = true;
                fb_top[p] = lnb[tb[o]];
                fb_bot[p] = lnb[tb[o + 1]];
            }
        }
        // --- field splits (split_frames_to_fields) ---
        int64_t s1[13], s2[13];
        const int64_t fa_et = state[ST_FA_ETOP], fa_eb = state[ST_FA_EBOT];
        const int64_t fa_ot = state[ST_FA_OTOP], fa_ob = state[ST_FA_OBOT];
        stc007_split_scan((const int64_t*)f1p[FP_LN],
                          (const int64_t*)f1p[FP_FN],
                          (const int8_t*)f1p[FP_SVC],
                          (const uint8_t*)f1p[FP_CRCV],
                          (const uint8_t*)f1p[FP_FORCED],
                          f1p[FP_LEN], fa_frno,
                          fa_et, fa_eb, !(fa_et == 0 && fa_eb == 0),
                          fa_ot, fa_ob, 1, LPF_PAL, s1, nullptr, nullptr);
        stc007_split_scan((const int64_t*)f2p[FP_LN],
                          (const int64_t*)f2p[FP_FN],
                          (const int8_t*)f2p[FP_SVC],
                          (const uint8_t*)f2p[FP_CRCV],
                          (const uint8_t*)f2p[FP_FORCED],
                          f2p[FP_LEN], fb_frno,
                          fb_top[0], fb_bot[0],
                          !(fb_top[0] == 0 && fb_bot[0] == 0),
                          fb_top[1], fb_bot[1], 1, LPF_PAL, s2,
                          nullptr, nullptr);
        for (int i = 0; i < 13; ++i) rec[RC_SPLIT + i] = s2[i];
        bool irregular = false;
        for (int p = 0; p < 2; ++p) {
            if (s1[1 + p * 6 + 2] > 0 && !s1[1 + p * 6 + 4])
                irregular = true;
            if (s2[1 + p * 6 + 2] > 0 && !s2[1 + p * 6 + 4])
                irregular = true;
        }
        if (irregular) {
            rec[RC_STATUS] = BS_SPLIT;
            break;
        }
        f1_max_line = s1[0];
        const int64_t fa_even_data = s1[1 + 0 * 6 + 2];
        const int64_t fa_odd_data = s1[1 + 1 * 6 + 2];
        const int64_t fb_even_data = s2[1 + 0 * 6 + 2];
        const int64_t fb_odd_data = s2[1 + 1 * 6 + 2];
        // --- detectVideoStandard core ---
        int vstd = VID_UNK;
        if (preset_vid == VID_UNK) {
            int64_t mx = fa_odd_data;
            if (fa_even_data > mx) mx = fa_even_data;
            if (fb_odd_data > mx) mx = fb_odd_data;
            if (fb_even_data > mx) mx = fb_even_data;
            if (mx > LPF_MAX_PAL) vstd = VID_UNK;
            else if (mx > LPF_MAX_NTSC) vstd = VID_PAL_C;
            else if (f1_max_line <= (LPF_PAL - 16) * 2) vstd = VID_NTSC_C;
            else vstd = VID_PAL_C;
        } else {
            vstd = preset_vid;
        }
        if (vstd == VID_UNK) vstd = (int)state[ST_F0_VID_STD];
        rec[RC_VSTD] = vstd;
        // --- TRY_PREVIOUS preconditions ---
        const int f0_order = (int)state[ST_F0_ORDER];
        const int fa_order_eff = preset_order ? preset_order
                                              : (int)state[ST_FA_ORDER];
        if (!(state[ST_F0_ODD_DATA] == fa_odd_data
              && state[ST_F0_EVEN_DATA] == fa_even_data
              && state[ST_F0_INNER_OK] && state[ST_F0_OUTER_OK])) {
            rec[RC_STATUS] = BS_TRY;
            break;
        }
        if (fa_order_preset && f0_order != fa_order_eff) {
            rec[RC_STATUS] = BS_TRY;
            break;
        }
        if (f0_order != ORD_TFF && f0_order != ORD_BFF) {
            rec[RC_STATUS] = BS_TRY;
            break;
        }
        if (fa_odd_data < MIN_FILL && fa_even_data < MIN_FILL) {
            rec[RC_STATUS] = BS_TRY;
            break;
        }
        const bool tff = f0_order == ORD_TFF;
        if (tff ? fb_odd_data < MIN_FILL : fb_even_data < MIN_FILL) {
            rec[RC_STATUS] = BS_TRY;
            break;
        }
        const int64_t res1o = state[ST_RES1O], res1e = state[ST_RES1E];
        if (fixed_mode < 0 && ((res1o != 14 && res1o != 16)
                               || (res1e != 14 && res1e != 16))) {
            rec[RC_STATUS] = BS_RES_UNK;
            break;
        }
        // M2 / a resolution preset fixes every mode (detectAudio-
        // Resolution short-circuit resp. getFieldResolution preset).
        const int fa_odd_mode = fixed_mode >= 0 ? fixed_mode
            : (res1o == 16 ? M16 : M14);
        const int fa_even_mode = fixed_mode >= 0 ? fixed_mode
            : (res1e == 16 ? M16 : M14);
        // --- materialize frame A fields + frame B leading field ---
        fld_e.fill(f1p, s1[1], s1[4], s1[3], en_cwd != 0);
        fld_o.fill(f1p, s1[7], s1[10], s1[9], en_cwd != 0);
        FieldBuf* field1 = tff ? &fld_o : &fld_e;
        FieldBuf* field2 = tff ? &fld_e : &fld_o;
        const int p2 = tff ? 1 : 0;  // f2 leading field parity (odd=1)
        f2f_buf.fill(f2p, s2[1 + p2 * 6 + 0], s2[1 + p2 * 6 + 3],
                     s2[1 + p2 * 6 + 2], en_cwd != 0);
        // --- fresh-field resolution counts (both f2 fields) ---
        // odd field first into rec[RC_RES], even into rec[RC_RES+2] —
        // matching the per-pair fast path's (f2o, f2e) order.
        if (!m2) {
            thread_local FieldBuf tmp;
            // odd
            tmp.fill(f2p, s2[7], s2[10], s2[9]);
            if (tmp.n > MDD)
                stc007_field_res_counts(tmp.w.data(), tmp.c.data(), tmp.n,
                                        tmp.n - MDD, 0,
                                        &rec[RC_RES], &rec[RC_RES + 1]);
            // even — reuse f2f_buf when it IS the even field
            if (p2 == 0) {
                if (f2f_buf.n > MDD)
                    stc007_field_res_counts(
                        f2f_buf.w.data(), f2f_buf.c.data(), f2f_buf.n,
                        f2f_buf.n - MDD, 0,
                        &rec[RC_RES + 2], &rec[RC_RES + 3]);
            } else {
                tmp.fill(f2p, s2[1], s2[4], s2[3]);
                if (tmp.n > MDD)
                    stc007_field_res_counts(tmp.w.data(), tmp.c.data(),
                                            tmp.n, tmp.n - MDD, 0,
                                            &rec[RC_RES + 2],
                                            &rec[RC_RES + 3]);
            }
        }
        // wait: when p2 == 1 (tff), the odd field IS f2f_buf — the tmp
        // fill above duplicated it.  Harmless (identical results), the
        // cost is one extra strided copy; kept for clarity.
        // --- assembly sizing (fillFrameForOutput A&B&C exact fit) ---
        const int64_t target = vstd == VID_PAL_C ? LPF_PAL
                               : (vstd == VID_NTSC_C ? LPF_NTSC
                                                     : LPF_DEFAULT);
        rec[RC_TARGET] = target;
        const int64_t c1 = std::min(field1->n, target);
        const int64_t c2 = std::min(field2->n, target);
        const int64_t padI = state[ST_F0_INNER_PAD];
        const int64_t padO = state[ST_F0_OUTER_PAD];
        if (c1 == 0 || c2 == 0 || padI < 0 || padO < 0
                || c1 + c2 + padI + padO != target * 2) {
            rec[RC_STATUS] = BS_FIT;
            break;
        }
        // --- seam resolution modes (all fixed under M2/preset) ---
        auto fa_mode_of = [&](int parity_odd) {
            return parity_odd ? fa_odd_mode : fa_even_mode;
        };
        // inner: every row frame A
        int inner_mode = fixed_mode >= 0 ? fixed_mode : M14;
        if (fixed_mode < 0) {
            const int64_t st1 = std::max<int64_t>(0, field1->n
                                                  - (KEEP - padI));
            const int64_t len1 = field1->n - st1;
            const int pf = (int)(field1->ln[st1] & 1);
            int pl;
            if (MDD < len1) pl = (int)(field1->ln[st1 + MDD] & 1);
            else if (MDD < len1 + padI)
                pl = (int)(field1->ln[field1->n - 1] & 1);
            else {
                const int64_t i2 = MDD - len1 - padI;
                if (i2 >= field2->n) {
                    rec[RC_STATUS] = BS_FIT;
                    break;
                }
                pl = (int)(field2->ln[i2] & 1);
            }
            inner_mode = res_mode_combine(fa_mode_of(pf), fa_mode_of(pl));
        }
        // outer: first row frame A; last may land in frame B
        int outer_mode = fixed_mode >= 0 ? fixed_mode : M14;
        if (fixed_mode < 0) {
            const int64_t st1 = std::max<int64_t>(0, field2->n
                                                  - (KEEP - padO));
            const int64_t len1 = field2->n - st1;
            const int pf = (int)(field2->ln[st1] & 1);
            const int first_mode = fa_mode_of(pf);
            if (MDD < len1) {
                outer_mode = res_mode_combine(
                    first_mode, fa_mode_of((int)(field2->ln[st1 + MDD]
                                                 & 1)));
            } else if (MDD < len1 + padO) {
                outer_mode = res_mode_combine(
                    first_mode,
                    fa_mode_of((int)(field2->ln[field2->n - 1] & 1)));
            } else {
                const int64_t i2 = MDD - len1 - padO;
                if (i2 >= f2f_buf.n) {
                    rec[RC_STATUS] = BS_FIT;
                    break;
                }
                const int plo = (int)(f2f_buf.ln[i2] & 1);
                const int ra = res_from_counts(rec[RC_RES],
                                               rec[RC_RES + 1]);
                const int rb = res_from_counts(rec[RC_RES + 2],
                                               rec[RC_RES + 3]);
                int fb_odd_m, fb_even_m;
                if (ra == 0 && rb == 0) {
                    // needs the 65-deep stats fallback: defer to Python
                    rec[RC_STATUS] = BS_RES_UNK;
                    break;
                } else if (ra == 0) {
                    fb_even_m = rb == 16 ? M16 : M14;
                    fb_odd_m = rb == 16 ? M16A : M14A;
                } else if (rb == 0) {
                    fb_odd_m = ra == 16 ? M16 : M14;
                    fb_even_m = ra == 16 ? M16A : M14A;
                } else {
                    fb_odd_m = ra == 16 ? M16 : M14;
                    fb_even_m = rb == 16 ? M16 : M14;
                }
                outer_mode = res_mode_combine(first_mode,
                                              plo ? fb_odd_m : fb_even_m);
            }
        }
        // --- seam evals + verdicts ---
        int32_t st4[4];
        {
            const int64_t st1 = std::max<int64_t>(0, field1->n
                                                  - (KEEP - padI));
            const int64_t cnt2 = std::min(field2->n, KEEP);
            int rc = stc007_eval_seam(
                field1->w.data() + st1 * 8, field1->c.data() + st1 * 8,
                field1->n - st1, padI, silent_w,
                field2->w.data(), field2->c.data(), cnt2,
                inner_mode, en_p, en_q, 1, m2, unch_lim,
                max_burst_silence, max_burst_broken, st4);
            if (rc != 0 || !seam_ok(st4, unch_lim, max_burst_silence,
                                    max_burst_broken)) {
                rec[RC_STATUS] = BS_SEAM_IN;
                break;
            }
        }
        {
            const int64_t st1 = std::max<int64_t>(0, field2->n
                                                  - (KEEP - padO));
            const int64_t cnt2 = std::min(f2f_buf.n, KEEP);
            int rc = stc007_eval_seam(
                field2->w.data() + st1 * 8, field2->c.data() + st1 * 8,
                field2->n - st1, padO, silent_w,
                f2f_buf.w.data(), f2f_buf.c.data(), cnt2,
                outer_mode, en_p, en_q, 1, m2, unch_lim,
                max_burst_silence, max_burst_broken, st4);
            if (rc != 0 || !seam_ok(st4, unch_lim, max_burst_silence,
                                    max_burst_broken)) {
                rec[RC_STATUS] = BS_SEAM_OUT;
                break;
            }
        }
        // --- frame A ref-level averages (for the replay) ---
        {
            const int64_t* ref1 = (const int64_t*)f1p[FP_REF];
            const uint8_t* crcv1 = (const uint8_t*)f1p[FP_CRCV];
            const uint8_t* forced1 = (const uint8_t*)f1p[FP_FORCED];
            for (int p = 0; p < 2; ++p) {
                const int64_t first = s1[1 + p * 6 + 0];
                const int64_t stp = s1[1 + p * 6 + 3];
                const int64_t cnt = s1[1 + p * 6 + 2];
                int64_t sum = 0, vsum = 0, vcnt = 0;
                for (int64_t k = 0; k < cnt; ++k) {
                    const int64_t r = first + k * stp;
                    sum += ref1[r];
                    if (crcv1[r] && !forced1[r]) {
                        vsum += ref1[r];
                        ++vcnt;
                    }
                }
                const int64_t avg = vcnt ? vsum / vcnt
                                         : (cnt ? sum / cnt : 0);
                rec[p == 0 ? RC_EREF : RC_OREF] = avg;
            }
        }
        // --- conv assembly + deint ---
        const int64_t L = n0 + target * 2;
        const int64_t B = L - MDD;
        int64_t pos = n0;
        auto put_field = [&](FieldBuf* f, int64_t cnt) {
            memcpy(&cw[(size_t)pos * 8], f->w.data(),
                   (size_t)cnt * 8 * sizeof(int32_t));
            memcpy(&cc[(size_t)pos * 8], f->c.data(), (size_t)cnt * 8);
            memcpy(&cln[(size_t)pos], f->ln.data(),
                   (size_t)cnt * sizeof(int64_t));
            for (int64_t k = 0; k < cnt; ++k) cfn[pos + k] = fa_frno;
            if (en_cwd) {
                memcpy(&csrc[pos], f->src.data(),
                       (size_t)cnt * sizeof(int64_t));
                memcpy(&cwc[(size_t)pos * 9], f->wc9.data(),
                       (size_t)cnt * 9);
                memcpy(&cwv[(size_t)pos * 9], f->wv9.data(),
                       (size_t)cnt * 9);
                memcpy(&cfb[pos], f->fb.data(), (size_t)cnt);
                memcpy(&ccv[pos], f->cv.data(), (size_t)cnt);
            }
            pos += cnt;
        };
        auto put_pad2 = [&](int64_t cnt, int64_t base_ln) {
            for (int64_t k = 0; k < cnt; ++k) {
                memcpy(&cw[(size_t)(pos + k) * 8], silent_w,
                       8 * sizeof(int32_t));
                cln[pos + k] = base_ln + 2 * k;
                cfn[pos + k] = fa_frno;
            }
            if (cnt) {
                memset(&cc[(size_t)pos * 8], 0, (size_t)cnt * 8);
                if (en_cwd) {
                    for (int64_t k = 0; k < cnt; ++k)
                        csrc[pos + k] = pad_src;
                    memset(&cwc[(size_t)pos * 9], 0, (size_t)cnt * 9);
                    memset(&cwv[(size_t)pos * 9], 0, (size_t)cnt * 9);
                    memset(&cfb[pos], 0, (size_t)cnt);
                    memset(&ccv[pos], 0, (size_t)cnt);
                }
            }
            pos += cnt;
        };
        put_field(field1, c1);
        put_pad2(padI, c1 ? field1->ln[c1 - 1] + 2 : 0);
        put_field(field2, c2);
        put_pad2(padO, c2 ? field2->ln[c2 - 1] + 2 : 0);
        // conv resolution mode from rows 0 and 112 (getDataBlockResolution)
        auto conv_res_of = [&](int64_t r) -> int {
            const int64_t fno = cfn[r];
            const int odd_p = (int)(cln[r] & 1);
            if (fno == fb_frno) return -1;
            if (fno == fa_frno) return fa_mode_of(odd_p);
            if (fno == state[ST_F0_FRNO])
                return (int)(odd_p ? state[ST_F0_ODD_MODE]
                                   : state[ST_F0_EVEN_MODE]);
            return M14;
        };
        const int cm0 = fixed_mode >= 0 ? fixed_mode : conv_res_of(0);
        const int cml = fixed_mode >= 0 ? fixed_mode : conv_res_of(MDD);
        if (cm0 < 0 || cml < 0) {
            rec[RC_STATUS] = BS_CONV;
            break;
        }
        const int conv_mode = fixed_mode >= 0 ? fixed_mode
            : res_mode_combine(cm0, cml);
        if (en_cwd) {
            // prescanFrame: extend with frame B's leading-field head,
            // run the performCWD write-back fixpoint, drop the
            // extension (rows beyond L simply stay unused).
            const int64_t ext = std::min<int64_t>(f2f_buf.n, MDD);
            for (int64_t k = 0; k < ext; ++k) {
                const int64_t r = L + k;
                memcpy(&cw[(size_t)r * 8], &f2f_buf.w[(size_t)k * 8],
                       8 * sizeof(int32_t));
                memcpy(&cc[(size_t)r * 8], &f2f_buf.c[(size_t)k * 8], 8);
                cln[r] = f2f_buf.ln[k];
                cfn[r] = fb_frno;
                csrc[r] = f2f_buf.src[k];
                memcpy(&cwc[(size_t)r * 9], &f2f_buf.wc9[(size_t)k * 9],
                       9);
                memcpy(&cwv[(size_t)r * 9], &f2f_buf.wv9[(size_t)k * 9],
                       9);
                cfb[r] = f2f_buf.fb[k];
                ccv[r] = f2f_buf.cv[k];
            }
            const int64_t Lx = L + ext;
            for (int64_t r = 0; r < Lx; ++r)
                ccrcv[r] = stc007_crc_row(&cw[(size_t)r * 8])
                    == (uint16_t)(csrc[r] & 0xFFFF);
            stc007_cwd_fixpoint(cw.data(), cc.data(), csrc.data(),
                                cwc.data(), cwv.data(), cfb.data(),
                                ccv.data(), ccrcv.data(), cfn.data(),
                                Lx, fb_frno, conv_mode, en_p, en_q, m2,
                                cwdline);
        }
        int64_t cnt6[6];
        const int64_t cd = stc007_deint_finalize(
            cw.data(), cc.data(), en_cwd ? cwdline.data() : nullptr,
            0, B, conv_mode, en_p, en_q,
            1, en_cwd, m2, nullptr, nullptr, 0, 0, 0, 0, 0,
            broken_mask_dur, (int32_t)state[ST_COUNTDOWN], 0, 0,
            samples + out_ofs * 6, wvalid + out_ofs * 6,
            wfixed + out_ofs * 6, bvalid + out_ofs, cnt6);
        if (cd < 0) {
            rec[RC_STATUS] = BS_ERR;
            break;
        }
        for (int i = 0; i < 6; ++i) rec[RC_CNT + i] = cnt6[i];
        rec[RC_CD] = cd;
        rec[RC_NBLK] = B;
        rec[RC_OFS] = out_ofs;
        out_ofs += B;
        // --- carry roll: conv tail MDD rows ---
        {
            const int64_t from = L - MDD;
            memmove(cw.data(), &cw[(size_t)from * 8],
                    (size_t)MDD * 8 * sizeof(int32_t));
            memmove(cc.data(), &cc[(size_t)from * 8], (size_t)MDD * 8);
            memmove(cln.data(), &cln[from], (size_t)MDD * sizeof(int64_t));
            memmove(cfn.data(), &cfn[from], (size_t)MDD * sizeof(int64_t));
            if (en_cwd) {
                memmove(csrc.data(), &csrc[from],
                        (size_t)MDD * sizeof(int64_t));
                memmove(cwc.data(), &cwc[(size_t)from * 9],
                        (size_t)MDD * 9);
                memmove(cwv.data(), &cwv[(size_t)from * 9],
                        (size_t)MDD * 9);
                memmove(cfb.data(), &cfb[from], (size_t)MDD);
                memmove(ccv.data(), &ccv[from], (size_t)MDD);
            }
            n0 = MDD;
        }
        // --- state roll (the replay applies the same to the frasms) ---
        state[ST_COUNTDOWN] = cd;
        state[ST_F0_ODD_DATA] = fa_odd_data;
        state[ST_F0_EVEN_DATA] = fa_even_data;
        state[ST_F0_INNER_PAD] = padI;
        state[ST_F0_OUTER_PAD] = padO;
        state[ST_F0_INNER_OK] = 1;
        state[ST_F0_OUTER_OK] = 1;
        state[ST_F0_ORDER] = f0_order;
        state[ST_F0_VID_STD] = vstd;
        state[ST_F0_FRNO] = fa_frno;
        state[ST_F0_ODD_MODE] = fa_odd_mode;
        state[ST_F0_EVEN_MODE] = fa_even_mode;
        state[ST_FA_FRNO] = fb_frno;
        state[ST_FA_TRIM_OK] = fb_found[0] && fb_found[1];
        state[ST_FA_ETOP] = fb_top[0];
        state[ST_FA_EBOT] = fb_bot[0];
        state[ST_FA_OTOP] = fb_top[1];
        state[ST_FA_OBOT] = fb_bot[1];
        state[ST_RES1O] = fixed_mode >= 0 ? (fixed_mode == M16 ? 16 : 14)
            : res_from_counts(rec[RC_RES], rec[RC_RES + 1]);
        state[ST_RES1E] = fixed_mode >= 0 ? (fixed_mode == M16 ? 16 : 14)
            : res_from_counts(rec[RC_RES + 2], rec[RC_RES + 3]);
        state[ST_FA_ORDER] = f0_order;  // fb.set_order_xff -> next fa
        state[ST_FA_NEW] = tb[8];
        state[ST_FA_END] = tb[9];
    }
    export_carry();
    return pair;
}

// ---------------------------------------------------------------------------
// Device-spec steady round: the stc007_steady_round state machine with
// every signal-path eval consumed from the DEVICE round dispatch's
// packed dual-resolution results (ops/device_stitch
// .steady_round_packed) instead of re-deriving them from line words.
// The chip does the binarize/ECC/seam/deint math; this is the host
// runtime's verify-and-consume loop (the C form of stitcher_stc007
// ._replay_spec_tail, one call per ROUND instead of per pair).
//
// packed1 [Bc] u32 per CONV block, resolution-SELECTED on device with
// pred_mode (bit layout valid[0:8] | line_crc[8:16] | flags[16:22] |
// STG_BAD_BLOCK at 22 | chosen-res at 23; the seam queues are reduced
// on device), conv_samples [Bc, 6] i16 (resolution-selected on device
// with the same pred_mode; a pair whose conv/seam mode differs bails
// BS_SPEC), res_counts [n_spec, 4] i64 (device-reduced fresh-field
// resolution counts), seam_stats [n_spec, 2, 4] i32 (device-reduced
// inner/outer burst counters under pred_mode + the dispatch
// unch_lim).
// seam_meta [n_pairs, 11] i64 per pair: (stats_row, inner_nb,
// stats_row, outer_nb, conv_ofs, conv_n, conv_samples_ofs,
// res_counts_row) (pads unused); a row with ofs < 0 has no spec.
// dev_plain [n_frames] u8: store words came straight from this device
// round (length 2*lpf, untouched).  The spec geometry (c1, c2, padI,
// padO, tff, target) is what the device's row maps assumed — any pair
// whose state-machine-derived geometry differs bails with BS_SPEC and
// the Python per-pair path decides.
// ---------------------------------------------------------------------------
int64_t stc007_spec_round(
    const int64_t* frames, int64_t n_frames,
    const int32_t* carry_w_in, const uint8_t* carry_c_in,
    const int64_t* carry_ln_in, const int64_t* carry_fn_in, int64_t n0_in,
    const int32_t* silent_w,
    int32_t en_q, int32_t unch_lim,
    int32_t max_burst_silence, int32_t max_burst_broken,
    int32_t broken_mask_dur, int32_t auto_m2, int32_t m2,
    int32_t fixed_mode,
    int32_t preset_order, int32_t preset_vid, int32_t fa_order_preset,
    const uint32_t* packed1, const int16_t* conv_samples,
    const int64_t* res_counts_in, const int32_t* seam_stats_in,
    const int64_t* seam_meta,
    const uint8_t* dev_plain,
    int64_t spec_c1, int64_t spec_c2, int64_t spec_padI,
    int64_t spec_padO, int32_t spec_tff, int64_t spec_target,
    int64_t lpf, int32_t pred_mode,
    const int32_t* spec_carry_w, const uint8_t* spec_carry_ok,
    int64_t spec_n0,
    int64_t* state, int64_t* records,
    int16_t* samples, uint8_t* wvalid, uint8_t* wfixed, uint8_t* bvalid) {
    const int64_t n_pairs = n_frames - 1;
    if (n_pairs <= 0 || !g_tables_set) return 0;
    constexpr int BS_SPEC = 11;

    thread_local std::vector<int64_t> cln, cfn;
    thread_local std::vector<uint8_t> fl, va, lc, ovalid, maskb;
    thread_local std::vector<int32_t> resb;
    const int64_t conv_cap = MDD + 2 * LPF_PAL + 8;
    if ((int64_t)cln.size() < conv_cap) {
        cln.resize((size_t)conv_cap);
        cfn.resize((size_t)conv_cap);
    }
    const int64_t bmax = conv_cap;
    if ((int64_t)fl.size() < bmax) {
        fl.resize((size_t)bmax);
        maskb.resize((size_t)bmax);
        resb.resize((size_t)bmax);
        va.resize((size_t)bmax * 8);
        lc.resize((size_t)bmax * 8);
        ovalid.resize((size_t)bmax * 8);
    }
    int64_t n0 = n0_in;
    if (n0 > MDD) return 0;
    if (n0) {
        memcpy(cln.data(), carry_ln_in, (size_t)n0 * sizeof(int64_t));
        memcpy(cfn.data(), carry_fn_in, (size_t)n0 * sizeof(int64_t));
    }
    int64_t out_ofs = 0;
    int64_t f1_max_line = -1;

    int64_t pair = 0;
    for (; pair < n_pairs; ++pair) {
        int64_t* rec = records + pair * RC_N;
        for (int i = 0; i < RC_N; ++i) rec[i] = 0;
        rec[RC_CB] = -1;
        const int64_t* f1p = frames + pair * FP_N;
        const int64_t* f2p = frames + (pair + 1) * FP_N;
        const int64_t fa_frno = f1p[FP_FRNO];
        const int64_t fb_frno = f2p[FP_FRNO];
        const int64_t* sm = seam_meta + pair * 11;
        if (fa_frno == fb_frno || fa_frno == state[ST_F0_FRNO]) {
            rec[RC_STATUS] = BS_CONV;
            rec[RC_CB] = -2;
            break;
        }
        // spec coverage + untouched device stores
        if (sm[0] < 0 || !dev_plain[pair] || !dev_plain[pair + 1]
                || f1p[FP_LEN] != 2 * lpf || f2p[FP_LEN] != 2 * lpf) {
            rec[RC_STATUS] = BS_SPEC;
            rec[RC_CB] = -2;
            break;
        }
        // pair 0: the live conv carry must equal the carry the device
        // round speculated with (stitcher_stc007._match_spec_entry).
        // spec_n0 < 0 = mid-round entry with the steady chain already
        // verified by Python (the device assumed the standard MDD-row
        // chained carry there, _match_spec_entry's pairs>0 rule).
        if (pair == 0) {
            if (spec_n0 < 0) {
                if (n0 != MDD) {
                    rec[RC_STATUS] = BS_SPEC;
                    rec[RC_CB] = -2;
                    break;
                }
            } else if (n0 != spec_n0
                    || (n0 && memcmp(carry_w_in, spec_carry_w,
                                     (size_t)n0 * 8 * sizeof(int32_t)))
                    || (n0 && memcmp(carry_c_in, spec_carry_ok,
                                     (size_t)n0 * 8))) {
                rec[RC_STATUS] = BS_SPEC;
                rec[RC_CB] = -2;
                break;
            }
        }
        // --- frame B trim scan (find_frames_trim) ---
        int64_t tb[14];
        stc007_trim_scan((const int64_t*)f2p[FP_LN],
                         (const int64_t*)f2p[FP_FN],
                         (const int8_t*)f2p[FP_SVC],
                         (const uint8_t*)f2p[FP_CRCV],
                         (const uint8_t*)f2p[FP_FORCED],
                         (const uint8_t*)f2p[FP_MARK],
                         f2p[FP_LEN], fb_frno, 1, tb);
        for (int i = 0; i < 14; ++i) rec[RC_TRIM + i] = tb[i];
        rec[RC_NEW] = tb[8];
        rec[RC_END] = tb[9];
        const bool cb_hit = tb[10] >= 0 && (tb[11] < 0 || tb[10] < tb[11]);
        rec[RC_CB] = cb_hit ? tb[10] : -1;
        if (state[ST_FA_NEW] || state[ST_FA_END] || tb[8] || tb[9]) {
            rec[RC_STATUS] = BS_FILE;
            break;
        }
        if (cb_hit && auto_m2) {
            rec[RC_STATUS] = BS_CB_AUTO_M2;
            break;
        }
        const int64_t* lnb = (const int64_t*)f2p[FP_LN];
        int64_t fb_top[2] = {0, 0}, fb_bot[2] = {0, 0};
        bool fb_found[2] = {false, false};
        for (int p = 0; p < 2; ++p) {
            const int base = p == 0 ? 0 : 4;
            const int good = p == 0 ? 12 : 13;
            const int o = tb[good] > MIN_GOOD ? base : base + 2;
            if (tb[o] >= 0) {
                fb_found[p] = true;
                fb_top[p] = lnb[tb[o]];
                fb_bot[p] = lnb[tb[o + 1]];
            }
        }
        // --- field splits ---
        int64_t s1[13], s2[13];
        const int64_t fa_et = state[ST_FA_ETOP], fa_eb = state[ST_FA_EBOT];
        const int64_t fa_ot = state[ST_FA_OTOP], fa_ob = state[ST_FA_OBOT];
        stc007_split_scan((const int64_t*)f1p[FP_LN],
                          (const int64_t*)f1p[FP_FN],
                          (const int8_t*)f1p[FP_SVC],
                          (const uint8_t*)f1p[FP_CRCV],
                          (const uint8_t*)f1p[FP_FORCED],
                          f1p[FP_LEN], fa_frno,
                          fa_et, fa_eb, !(fa_et == 0 && fa_eb == 0),
                          fa_ot, fa_ob, 1, LPF_PAL, s1, nullptr, nullptr);
        stc007_split_scan((const int64_t*)f2p[FP_LN],
                          (const int64_t*)f2p[FP_FN],
                          (const int8_t*)f2p[FP_SVC],
                          (const uint8_t*)f2p[FP_CRCV],
                          (const uint8_t*)f2p[FP_FORCED],
                          f2p[FP_LEN], fb_frno,
                          fb_top[0], fb_bot[0],
                          !(fb_top[0] == 0 && fb_bot[0] == 0),
                          fb_top[1], fb_bot[1], 1, LPF_PAL, s2,
                          nullptr, nullptr);
        for (int i = 0; i < 13; ++i) rec[RC_SPLIT + i] = s2[i];
        // plain splits: the device's row maps assumed odd = store rows
        // [0, lpf), even = [lpf, 2*lpf), unit stride, for BOTH frames.
        // (split layout per parity, base=1+p*6: +0 first, +2 count,
        //  +3 step; p=0 even, p=1 odd.)
        bool plain = true;
        for (const int64_t* s : {(const int64_t*)s1, (const int64_t*)s2}) {
            if (!(s[1 + 0 * 6 + 0] == lpf && s[1 + 0 * 6 + 2] == lpf
                  && s[1 + 0 * 6 + 3] == 1
                  && s[1 + 1 * 6 + 0] == 0 && s[1 + 1 * 6 + 2] == lpf
                  && s[1 + 1 * 6 + 3] == 1))
                plain = false;
        }
        if (!plain) {
            rec[RC_STATUS] = BS_SPEC;
            break;
        }
        f1_max_line = s1[0];
        const int64_t fa_even_data = lpf, fa_odd_data = lpf;
        const int64_t fb_even_data = lpf, fb_odd_data = lpf;
        // --- detectVideoStandard core ---
        int vstd = VID_UNK;
        if (preset_vid == VID_UNK) {
            const int64_t mx = lpf;
            if (mx > LPF_MAX_PAL) vstd = VID_UNK;
            else if (mx > LPF_MAX_NTSC) vstd = VID_PAL_C;
            else if (f1_max_line <= (LPF_PAL - 16) * 2) vstd = VID_NTSC_C;
            else vstd = VID_PAL_C;
        } else {
            vstd = preset_vid;
        }
        if (vstd == VID_UNK) vstd = (int)state[ST_F0_VID_STD];
        rec[RC_VSTD] = vstd;
        // --- TRY_PREVIOUS preconditions ---
        const int f0_order = (int)state[ST_F0_ORDER];
        const int fa_order_eff = preset_order ? preset_order
                                              : (int)state[ST_FA_ORDER];
        if (!(state[ST_F0_ODD_DATA] == fa_odd_data
              && state[ST_F0_EVEN_DATA] == fa_even_data
              && state[ST_F0_INNER_OK] && state[ST_F0_OUTER_OK])) {
            rec[RC_STATUS] = BS_TRY;
            break;
        }
        if (fa_order_preset && f0_order != fa_order_eff) {
            rec[RC_STATUS] = BS_TRY;
            break;
        }
        if (f0_order != ORD_TFF && f0_order != ORD_BFF) {
            rec[RC_STATUS] = BS_TRY;
            break;
        }
        if (fa_odd_data < MIN_FILL && fa_even_data < MIN_FILL) {
            rec[RC_STATUS] = BS_TRY;
            break;
        }
        const bool tff = f0_order == ORD_TFF;
        if (tff ? fb_odd_data < MIN_FILL : fb_even_data < MIN_FILL) {
            rec[RC_STATUS] = BS_TRY;
            break;
        }
        const int64_t res1o = state[ST_RES1O], res1e = state[ST_RES1E];
        if (fixed_mode < 0 && ((res1o != 14 && res1o != 16)
                               || (res1e != 14 && res1e != 16))) {
            rec[RC_STATUS] = BS_RES_UNK;
            break;
        }
        const int fa_odd_mode = fixed_mode >= 0 ? fixed_mode
            : (res1o == 16 ? M16 : M14);
        const int fa_even_mode = fixed_mode >= 0 ? fixed_mode
            : (res1e == 16 ? M16 : M14);
        // plain field row->line maps: odd field k -> line 1+2k of frame
        // A (store rows [0, lpf)), even -> 2+2k (rows [lpf, 2lpf)).
        const int64_t* ln1 = (const int64_t*)f1p[FP_LN];
        const int64_t* ln2 = (const int64_t*)f2p[FP_LN];
        const int64_t fld1_row0 = tff ? 0 : lpf;    // leading field of A
        const int64_t fld2_row0 = tff ? lpf : 0;
        const int64_t f2f_row0 = tff ? 0 : lpf;     // leading field of B
        // --- fresh-field resolution counts (reduced on device) ---
        if (!m2) {
            const int64_t* rcs = res_counts_in + sm[7] * 4;
            for (int i = 0; i < 4; ++i) rec[RC_RES + i] = rcs[i];
        }
        // --- assembly sizing + spec geometry verification ---
        const int64_t target = vstd == VID_PAL_C ? LPF_PAL
                               : (vstd == VID_NTSC_C ? LPF_NTSC
                                                     : LPF_DEFAULT);
        rec[RC_TARGET] = target;
        const int64_t c1 = std::min(lpf, target);
        const int64_t c2 = std::min(lpf, target);
        const int64_t padI = state[ST_F0_INNER_PAD];
        const int64_t padO = state[ST_F0_OUTER_PAD];
        if (c1 == 0 || c2 == 0 || padI < 0 || padO < 0
                || c1 + c2 + padI + padO != target * 2) {
            rec[RC_STATUS] = BS_FIT;
            break;
        }
        if (c1 != spec_c1 || c2 != spec_c2 || padI != spec_padI
                || padO != spec_padO || (int32_t)tff != spec_tff
                || target != spec_target) {
            rec[RC_STATUS] = BS_SPEC;
            break;
        }
        // --- seam resolution modes (fixed under M2/preset) ---
        auto fa_mode_of = [&](int parity_odd) {
            return parity_odd ? fa_odd_mode : fa_even_mode;
        };
        auto fld_ln = [&](const int64_t* ln, int64_t row0, int64_t k) {
            return ln[row0 + k];
        };
        int inner_mode = fixed_mode >= 0 ? fixed_mode : M14;
        if (fixed_mode < 0) {
            const int64_t st1 = std::max<int64_t>(0, lpf - (KEEP - padI));
            const int64_t len1 = lpf - st1;
            const int pf = (int)(fld_ln(ln1, fld1_row0, st1) & 1);
            int pl;
            if (MDD < len1)
                pl = (int)(fld_ln(ln1, fld1_row0, st1 + MDD) & 1);
            else if (MDD < len1 + padI)
                pl = (int)(fld_ln(ln1, fld1_row0, lpf - 1) & 1);
            else {
                const int64_t i2 = MDD - len1 - padI;
                if (i2 >= lpf) {
                    rec[RC_STATUS] = BS_FIT;
                    break;
                }
                pl = (int)(fld_ln(ln1, fld2_row0, i2) & 1);
            }
            inner_mode = res_mode_combine(fa_mode_of(pf), fa_mode_of(pl));
        }
        int outer_mode = fixed_mode >= 0 ? fixed_mode : M14;
        if (fixed_mode < 0) {
            const int64_t st1 = std::max<int64_t>(0, lpf - (KEEP - padO));
            const int64_t len1 = lpf - st1;
            const int pf = (int)(fld_ln(ln1, fld2_row0, st1) & 1);
            const int first_mode = fa_mode_of(pf);
            if (MDD < len1) {
                outer_mode = res_mode_combine(
                    first_mode,
                    fa_mode_of((int)(fld_ln(ln1, fld2_row0, st1 + MDD)
                                     & 1)));
            } else if (MDD < len1 + padO) {
                outer_mode = res_mode_combine(
                    first_mode,
                    fa_mode_of((int)(fld_ln(ln1, fld2_row0, lpf - 1)
                                     & 1)));
            } else {
                const int64_t i2 = MDD - len1 - padO;
                if (i2 >= lpf) {
                    rec[RC_STATUS] = BS_FIT;
                    break;
                }
                const int plo = (int)(fld_ln(ln2, f2f_row0, i2) & 1);
                const int ra = res_from_counts(rec[RC_RES],
                                               rec[RC_RES + 1]);
                const int rb = res_from_counts(rec[RC_RES + 2],
                                               rec[RC_RES + 3]);
                int fb_odd_m, fb_even_m;
                if (ra == 0 && rb == 0) {
                    rec[RC_STATUS] = BS_RES_UNK;
                    break;
                } else if (ra == 0) {
                    fb_even_m = rb == 16 ? M16 : M14;
                    fb_odd_m = rb == 16 ? M16A : M14A;
                } else if (rb == 0) {
                    fb_odd_m = ra == 16 ? M16 : M14;
                    fb_even_m = ra == 16 ? M16A : M14A;
                } else {
                    fb_odd_m = ra == 16 ? M16 : M14;
                    fb_even_m = rb == 16 ? M16 : M14;
                }
                outer_mode = res_mode_combine(first_mode,
                                              plo ? fb_odd_m : fb_even_m);
            }
        }
        // --- seam verdicts from the device-reduced burst counters ---
        // (computed on device under pred_mode with the dispatch's
        // unch_lim; any seam whose replay mode disagrees makes the
        // speculation unusable for this pair.)
        if (inner_mode != pred_mode || outer_mode != pred_mode) {
            rec[RC_STATUS] = BS_SPEC;
            break;
        }
        auto seam_from_spec = [&](int64_t srow, int sel, int64_t nb,
                                  int32_t* st4) {
            const int32_t* s = seam_stats_in + (srow * 2 + sel) * 4;
            for (int i = 0; i < 4; ++i) st4[i] = s[i];
            return nb > 0 && seam_ok(st4, unch_lim, max_burst_silence,
                                     max_burst_broken);
        };
        int32_t st4[4];
        if (!seam_from_spec(sm[0], 0, sm[1], st4)) {
            rec[RC_STATUS] = BS_SEAM_IN;
            break;
        }
        if (!seam_from_spec(sm[2], 1, sm[3], st4)) {
            rec[RC_STATUS] = BS_SEAM_OUT;
            break;
        }
        // --- frame A ref-level averages (for the replay) ---
        {
            const int64_t* ref1 = (const int64_t*)f1p[FP_REF];
            const uint8_t* crcv1 = (const uint8_t*)f1p[FP_CRCV];
            const uint8_t* forced1 = (const uint8_t*)f1p[FP_FORCED];
            for (int p = 0; p < 2; ++p) {
                const int64_t first = p == 0 ? lpf : 0;  // even | odd
                int64_t sum = 0, vsum = 0, vcnt = 0;
                for (int64_t k = 0; k < lpf; ++k) {
                    const int64_t r = first + k;
                    sum += ref1[r];
                    if (crcv1[r] && !forced1[r]) {
                        vsum += ref1[r];
                        ++vcnt;
                    }
                }
                const int64_t avg = vcnt ? vsum / vcnt
                                         : (lpf ? sum / lpf : 0);
                rec[p == 0 ? RC_EREF : RC_OREF] = avg;
            }
        }
        // --- conv line/frame numbers (mode lookups + the carry roll) --
        const int64_t L = n0 + target * 2;
        const int64_t B = L - MDD;
        if (sm[5] != B || B <= 0) {
            rec[RC_STATUS] = BS_SPEC;
            break;
        }
        int64_t pos = n0;
        auto put_field_ln = [&](const int64_t* ln, int64_t row0,
                                int64_t cnt) {
            for (int64_t k = 0; k < cnt; ++k) {
                cln[pos + k] = ln[row0 + k];
                cfn[pos + k] = fa_frno;
            }
            pos += cnt;
        };
        auto put_pad_ln = [&](int64_t cnt, int64_t base_ln) {
            for (int64_t k = 0; k < cnt; ++k) {
                cln[pos + k] = base_ln + 2 * k;
                cfn[pos + k] = fa_frno;
            }
            pos += cnt;
        };
        put_field_ln(ln1, fld1_row0, c1);
        put_pad_ln(padI, c1 ? fld_ln(ln1, fld1_row0, c1 - 1) + 2 : 0);
        put_field_ln(ln1, fld2_row0, c2);
        put_pad_ln(padO, c2 ? fld_ln(ln1, fld2_row0, c2 - 1) + 2 : 0);
        auto conv_res_of = [&](int64_t r) -> int {
            const int64_t fno = cfn[r];
            const int odd_p = (int)(cln[r] & 1);
            if (fno == fb_frno) return -1;
            if (fno == fa_frno) return fa_mode_of(odd_p);
            if (fno == state[ST_F0_FRNO])
                return (int)(odd_p ? state[ST_F0_ODD_MODE]
                                   : state[ST_F0_EVEN_MODE]);
            return M14;
        };
        const int cm0 = fixed_mode >= 0 ? fixed_mode : conv_res_of(0);
        const int cml = fixed_mode >= 0 ? fixed_mode : conv_res_of(MDD);
        if (cm0 < 0 || cml < 0) {
            rec[RC_STATUS] = BS_CONV;
            break;
        }
        const int conv_mode = fixed_mode >= 0 ? fixed_mode
            : res_mode_combine(cm0, cml);
        if (conv_mode != pred_mode) {
            // The device pre-selected samples for a different mode:
            // this pair's speculation is unusable.
            rec[RC_STATUS] = BS_SPEC;
            break;
        }
        // --- conv finalize from the device's packed eval ---
        // (pack AND samples were resolution-selected ON DEVICE with
        // pred_mode == conv_mode; the chosen resolution rides bit 23.)
        const int64_t c_ofs = sm[4], cs_ofs = sm[6];
        for (int64_t i = 0; i < B; ++i) {
            const uint32_t sel = packed1[c_ofs + i];
            fl[i] = (sel >> 16) & 0x3F;
            resb[i] = (sel >> 23) & 1;
            for (int k = 0; k < 8; ++k) {
                va[i * 8 + k] = (sel >> k) & 1;
                lc[i * 8 + k] = (sel >> (8 + k)) & 1;
            }
        }
        memcpy(samples + out_ofs * 6, conv_samples + cs_ofs * 6,
               (size_t)B * 6 * sizeof(int16_t));
        int64_t cnt6[6];
        const int32_t cd = stc007_finalize_blocks(
            fl.data(), va.data(), lc.data(), resb.data(), nullptr,
            nullptr, nullptr, B, 0, 0, 0, 0, 0, 0,
            broken_mask_dur, (int32_t)state[ST_COUNTDOWN], 0, 0,
            ovalid.data(), wvalid + out_ofs * 6, wfixed + out_ofs * 6,
            bvalid + out_ofs, maskb.data(), cnt6);
        if (cd < 0) {
            rec[RC_STATUS] = BS_ERR;
            break;
        }
        for (int i = 0; i < 6; ++i) rec[RC_CNT + i] = cnt6[i];
        rec[RC_CD] = cd;
        rec[RC_NBLK] = B;
        rec[RC_OFS] = out_ofs;
        out_ofs += B;
        // --- carry roll: conv tail MDD rows (numbers only) ---
        {
            const int64_t from = L - MDD;
            memmove(cln.data(), &cln[from], (size_t)MDD * sizeof(int64_t));
            memmove(cfn.data(), &cfn[from], (size_t)MDD * sizeof(int64_t));
            n0 = MDD;
        }
        // --- state roll ---
        state[ST_COUNTDOWN] = cd;
        state[ST_F0_ODD_DATA] = fa_odd_data;
        state[ST_F0_EVEN_DATA] = fa_even_data;
        state[ST_F0_INNER_PAD] = padI;
        state[ST_F0_OUTER_PAD] = padO;
        state[ST_F0_INNER_OK] = 1;
        state[ST_F0_OUTER_OK] = 1;
        state[ST_F0_ORDER] = f0_order;
        state[ST_F0_VID_STD] = vstd;
        state[ST_F0_FRNO] = fa_frno;
        state[ST_F0_ODD_MODE] = fa_odd_mode;
        state[ST_F0_EVEN_MODE] = fa_even_mode;
        state[ST_FA_FRNO] = fb_frno;
        state[ST_FA_TRIM_OK] = fb_found[0] && fb_found[1];
        state[ST_FA_ETOP] = fb_top[0];
        state[ST_FA_EBOT] = fb_bot[0];
        state[ST_FA_OTOP] = fb_top[1];
        state[ST_FA_OBOT] = fb_bot[1];
        state[ST_RES1O] = fixed_mode >= 0 ? (fixed_mode == M16 ? 16 : 14)
            : res_from_counts(rec[RC_RES], rec[RC_RES + 1]);
        state[ST_RES1E] = fixed_mode >= 0 ? (fixed_mode == M16 ? 16 : 14)
            : res_from_counts(rec[RC_RES + 2], rec[RC_RES + 3]);
        state[ST_FA_ORDER] = f0_order;
        state[ST_FA_NEW] = tb[8];
        state[ST_FA_END] = tb[9];
    }
    return pair;
}

// ---------------------------------------------------------------------------
// HuffYUV (HFYU) frame decode — native twin of pipeline/huffyuv.py
// (_decode_frame_py is the spec; this is the ingest production path,
// the reference decodes HFYU through libav, ffmpegwrapper.cpp:543).
// YUY2 left-predictor streams: first 4:2:2 group raw in data[0..3],
// then Huffman-coded per-channel deltas interleaved Y U Y V, bits
// MSB-first from 32-bit little-endian words.  Canonical tables built
// from the three 256-entry code-length vectors.  Writes the LUMA
// plane only ([H, W]); returns 0 ok, negative on malformed input.
// ---------------------------------------------------------------------------
namespace {
struct HfyuTable {
    int64_t base[33];      // canonical first code per length
    int16_t sym[33][256];  // symbols of each length, ascending
    int16_t cnt[33];
    void build(const uint8_t* lens) {
        int64_t count[34] = {0};
        for (int i = 0; i < 256; ++i) ++count[lens[i]];
        int64_t codes[34] = {0};
        for (int len = 32; len > 0; --len)
            codes[len - 1] = (codes[len] + count[len]) >> 1;
        for (int len = 1; len <= 32; ++len) {
            base[len] = codes[len];
            cnt[len] = 0;
        }
        for (int i = 0; i < 256; ++i) {
            const int len = lens[i];
            if (len) sym[len][cnt[len]++] = (int16_t)i;
        }
    }
};
}  // namespace

int hfyu_decode_yuy2(const uint8_t* data, int64_t n_bytes,
                     const uint8_t* len_y, const uint8_t* len_u,
                     const uint8_t* len_v,
                     int64_t W, int64_t H, uint8_t* luma_out) {
    if (n_bytes < 4 || W <= 0 || (W & 1) || H <= 0) return -1;
    thread_local HfyuTable ty, tu, tv;
    ty.build(len_y);
    tu.build(len_u);
    tv.build(len_v);
    const int64_t n_samples = W * H * 2;
    const uint8_t* bs = data + 4;
    const int64_t n_words = (n_bytes - 4) / 4;
    const int64_t n_bits = n_words * 32;
    int64_t bitpos = 0;
    uint8_t py = data[2], pu = data[1], pv = data[3];
    luma_out[0] = data[0];
    luma_out[1] = data[2];
    auto read_sym = [&](const HfyuTable& t, int* out_sym) -> bool {
        int64_t v = 0;
        for (int len = 1; len <= 32; ++len) {
            if (bitpos >= n_bits) return false;
            const int64_t w = bitpos >> 5;
            const uint32_t word = (uint32_t)bs[w * 4]
                | ((uint32_t)bs[w * 4 + 1] << 8)
                | ((uint32_t)bs[w * 4 + 2] << 16)
                | ((uint32_t)bs[w * 4 + 3] << 24);
            const int bit = 31 - (int)(bitpos & 31);
            v = (v << 1) | ((word >> bit) & 1);
            ++bitpos;
            if (t.cnt[len]) {
                const int64_t rel = v - t.base[len];
                if (rel >= 0 && rel < t.cnt[len]) {
                    *out_sym = t.sym[len][rel];
                    return true;
                }
            }
        }
        return false;
    };
    int64_t yi = 2;  // luma samples written
    for (int64_t i = 4; i < n_samples; ++i) {
        int d;
        switch (i & 3) {
        case 0: case 2:
            if (!read_sym(ty, &d)) return -2;
            py = (uint8_t)(py + d);
            luma_out[yi++] = py;
            break;
        case 1:
            if (!read_sym(tu, &d)) return -2;
            pu = (uint8_t)(pu + d);
            break;
        default:
            if (!read_sym(tv, &d)) return -2;
            pv = (uint8_t)(pv + d);
            break;
        }
    }
    (void)pu; (void)pv;
    return 0;
}

// ---------------------------------------------------------------------------
// Lagarith (LAGS) plane decode — native twin of pipeline/lagarith.py
// decode_plane (the Python module is the spec; this is the ingest
// production path — the reference decodes LAGS through libav,
// ffmpegwrapper.cpp:543).  Covers rac (esc 1..3), raw-residual (4)
// and solid (0xff) plane modes with the softfloat probability rescale.
// Returns 0 ok; -1 malformed; -2 bitstream overrun/overread;
// -3 zero-run-line coding (esc 5..7, unsupported by design);
// -4 invalid escape code.
// ---------------------------------------------------------------------------
namespace lagsns {

constexpr uint64_t RAC_TOP = 0x800000;
constexpr int SERIES[7] = {1, 2, 3, 5, 8, 13, 21};

struct BitR {
    const uint8_t* d;
    int64_t n;       // total bytes
    int64_t pos;     // bit position
    bool err;
    int bit() {
        const int64_t p = pos;
        if ((p >> 3) >= n) { err = true; return 0; }
        pos = p + 1;
        return (d[p >> 3] >> (7 - (p & 7))) & 1;
    }
    int64_t bits(int k) {
        int64_t v = 0;
        for (int i = 0; i < k; ++i) v = (v << 1) | bit();
        return v;
    }
    int64_t align_byte() {
        pos = (pos + 7) & ~int64_t(7);
        return pos >> 3;
    }
};

// _read_prob_vlc: Zeckendorf prefix -> bit count, then literal bits.
static int64_t read_prob_vlc(BitR& br) {
    int bitv = 0, prevbit = 0;
    int64_t nbits = 0;
    for (int i = 0; i < 7; ++i) {
        if (prevbit && bitv) break;
        prevbit = bitv;
        bitv = br.bit();
        if (bitv && !prevbit) nbits += SERIES[i];
    }
    nbits -= 1;
    if (br.err || nbits < 0 || nbits > 31) { br.err = true; return -1; }
    if (nbits == 0) return 0;
    const int64_t val = br.bits((int)nbits) | (int64_t(1) << nbits);
    return val - 1;
}

// scale_prob_table: raw probs[256] -> cum[257] + scale (softfloat
// rescale when the sum is not a power of two).
static int scale_prob_table(int64_t* probs, uint64_t* cum, int* scale_out) {
    int64_t cumul = 0;
    for (int i = 0; i < 256; ++i) cumul += probs[i];
    if (cumul <= 0) return -1;
    int scale = 63 - __builtin_clzll((uint64_t)cumul);
    if (cumul & (cumul - 1)) {
        scale += 1;
        if (scale >= 32) return -1;
        const uint64_t target = uint64_t(1) << scale;
        uint64_t ssum = 0;
        for (int i = 0; i < 256; ++i) {
            probs[i] = (int64_t)(((unsigned __int128)(uint64_t)probs[i]
                                  * target) / (uint64_t)cumul);
            ssum += (uint64_t)probs[i];
        }
        if (ssum > target) return -1;
        int64_t deficit = (int64_t)(target - ssum);
        int cycle[256];
        int nc = 0;
        for (int i = 0; i < 128; ++i) if (probs[i]) cycle[nc++] = i;
        if (!nc)
            for (int i = 0; i < 256; ++i) if (probs[i]) cycle[nc++] = i;
        if (!nc) return -1;
        for (int64_t k = 0; deficit > 0; ++k, --deficit)
            probs[cycle[k % nc]] += 1;
    }
    cum[0] = 0;
    for (int i = 0; i < 256; ++i) cum[i + 1] = cum[i] + (uint64_t)probs[i];
    *scale_out = scale;
    return 0;
}

struct Rac {
    const uint8_t* d;
    int64_t n;
    int64_t pos, end;
    const uint64_t* cum;
    int scale;
    uint64_t range, low;
    int overread;
    bool err;
    void init(const uint8_t* data, int64_t nbytes, int64_t start,
              int64_t end_, const uint64_t* c, int sc) {
        d = data; n = nbytes; pos = start; end = end_;
        cum = c; scale = sc;
        range = 0x80;
        low = start < n ? (uint64_t)(d[start] >> 1) : 0;
        overread = 0;
        err = false;
    }
    void refill() {
        while (range <= RAC_TOP) {
            low = (low << 8) & 0xFFFFFFFFFFull;
            range <<= 8;
            const uint32_t b0 = pos < n ? d[pos] : 0;
            const uint32_t b1 = pos + 1 < n ? d[pos + 1] : 0;
            low |= 0xFF & (((b0 << 8) | b1) >> 1);
            if (pos < end) {
                ++pos;
            } else if (++overread > 16) {
                err = true;
                return;
            }
        }
    }
    int get() {
        refill();
        if (err) return 0;
        const uint64_t rs = range >> scale;
        int val;
        if (low < rs * cum[255]) {
            const uint64_t ls = low / rs;
            int lo = 0, hi = 255;
            while (lo < hi) {
                const int mid = (lo + hi + 1) >> 1;
                if (cum[mid] <= ls) lo = mid; else hi = mid - 1;
            }
            val = lo;
        } else {
            val = 255;
        }
        low -= rs * cum[val];
        if (val != 255) range = rs * (cum[val + 1] - cum[val]);
        else range -= rs * cum[255];
        return val;
    }
};

// lag_calc_zero_run: zigzag byte -> run length.
static inline int calc_zero_run(int x) {
    x &= 0xFF;
    if (x & 0x80) x -= 256;
    return ((x * 2) ^ (x >> 7)) & 0xFF;
}

static inline uint8_t mid_pred(int a, int b, int c) {
    if (a > b) { const int t = a; a = b; b = t; }
    const int v = c < a ? a : (c > b ? b : c);
    return (uint8_t)v;
}

// _apply_pred: residuals -> pixels (median predictor, planar path).
static void apply_pred(uint8_t* p, int64_t W, int64_t H) {
    // row 0: left prediction
    uint8_t acc = p[0];
    for (int64_t i = 1; i < W; ++i) {
        acc = (uint8_t)(acc + p[i]);
        p[i] = acc;
    }
    for (int64_t r = 1; r < H; ++r) {
        uint8_t* row = p + r * W;
        const uint8_t* top = row - W;
        int L = top[W - 1];
        int TL = r == 1 ? top[0] : (int)top[-1];  // prev2[W-1] == top[-1]
        for (int64_t i = 0; i < W; ++i) {
            const int T = top[i];
            const int pred = mid_pred(L, T, L + T - TL);
            L = (row[i] + pred) & 0xFF;
            row[i] = (uint8_t)L;
            TL = T;
        }
    }
}

}  // namespace lagsns

int lags_decode_plane(const uint8_t* src, int64_t n, int64_t spos,
                      int64_t W, int64_t H, uint8_t* out) {
    using namespace lagsns;
    if (W <= 0 || H <= 0 || spos < 0 || n - spos < 2) return -1;
    const int esc = src[spos];
    const int64_t npx = W * H;
    if (esc == 0) return -1;
    if (esc < 4) {
        int64_t length = npx;
        int64_t offset = spos + 1;
        if (n - offset >= 4) {
            const int64_t hdr_len = (int64_t)src[offset]
                | ((int64_t)src[offset + 1] << 8)
                | ((int64_t)src[offset + 2] << 16)
                | ((int64_t)src[offset + 3] << 24);
            if (hdr_len < length) {
                length = hdr_len;
                offset += 4;
            }
        }
        BitR br{src, n, offset * 8, false};
        int64_t probs[256] = {0};
        for (int i = 0; i < 256;) {
            const int64_t p = read_prob_vlc(br);
            if (br.err) return -1;
            probs[i] = p;
            if (p == 0) {
                int64_t run = read_prob_vlc(br);
                if (br.err) return -1;
                if (run > 255 - i) run = 255 - i;
                i += (int)run;
            }
            ++i;
        }
        uint64_t cum[257];
        int scale;
        if (scale_prob_table(probs, cum, &scale) != 0) return -1;
        const int64_t rac_start = br.align_byte();
        int64_t rac_end = rac_start + length;
        if (rac_end > n) rac_end = n;
        Rac rac;
        rac.init(src, n, rac_start, rac_end, cum, scale);
        // _decode_rac_line over all rows (zeros/zeros_rem persist)
        int zeros = 0;
        int64_t zeros_rem = 0;
        for (int64_t r = 0; r < H; ++r) {
            uint8_t* dst = out + r * W;
            int64_t i = 0;
            for (;;) {
                if (zeros_rem) {
                    int64_t count = zeros_rem < W - i ? zeros_rem : W - i;
                    memset(dst + i, 0, (size_t)count);
                    i += count;
                    zeros_rem -= count;
                }
                bool esc_hit = false;
                while (i < W) {
                    const int v = rac.get();
                    if (rac.err) return -2;
                    dst[i++] = (uint8_t)v;
                    zeros = v ? 0 : zeros + 1;
                    if (zeros == esc) {
                        const int idx = rac.get();
                        if (rac.err) return -2;
                        zeros = 0;
                        zeros_rem = calc_zero_run(idx);
                        esc_hit = true;
                        break;
                    }
                }
                if (!esc_hit) break;
                if (i >= W && !zeros_rem) break;
            }
        }
        apply_pred(out, W, H);
    } else if (esc == 4) {
        if (n - (spos + 1) < npx) return -1;
        memcpy(out, src + spos + 1, (size_t)npx);
        apply_pred(out, W, H);
    } else if (esc < 8) {
        return -3;
    } else if (esc == 0xFF) {
        memset(out, spos + 1 < n ? src[spos + 1] : 0, (size_t)npx);
    } else {
        return -4;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Ut Video (ULY0/ULY2) plane decode — native twin of pipeline/utvideo.py
// decode_plane (the Python module is the spec; this is the ingest
// production path — the reference decodes Ut Video through libav,
// ffmpegwrapper.cpp:543).  Returns 0 ok; -1 truncated; -2 invalid
// code; -3 bad slice offsets; -4 empty code-length table.
// ---------------------------------------------------------------------------
namespace ulyns {

struct UlyVlc {
    uint32_t lo[33];
    int16_t cnt[33];
    uint8_t syms[33][256];  // symbols by (code - lo) per length
    int fsym;               // >= 0: single-symbol plane
    int max_len;
    int build(const uint8_t* lens) {
        fsym = -1;
        max_len = 0;
        for (int l = 0; l <= 32; ++l) cnt[l] = 0;
        // first sorted (len, sym) entry: smallest used length, then
        // smallest symbol — length 0 there means an fsym plane.
        int min_len = 256, min_sym = -1;
        for (int s = 0; s < 256; ++s) {
            const int l = lens[s];
            if (l == 255) continue;
            if (l < min_len) { min_len = l; min_sym = s; }
        }
        if (min_sym < 0) return -4;
        if (min_len == 0) { fsym = min_sym; return 0; }
        // assign codes from the last sorted entry upward (descending
        // length, descending symbol) with wrapping uint32 arithmetic
        uint32_t code = 1;
        for (int l = 32; l >= 1; --l) {
            for (int s = 255; s >= 0; --s) {
                if (lens[s] != l) continue;
                const uint32_t c = code >> (32 - l);
                if (!cnt[l]) lo[l] = c;
                syms[l][cnt[l]++] = (uint8_t)s;
                code += (uint32_t)1 << (32 - l);
                if (l > max_len) max_len = l;
            }
        }
        return 0;
    }
};

inline uint8_t uly_mid_pred(int a, int b, int c) {
    if (a > b) { const int t = a; a = b; b = t; }
    const int v = c < a ? a : (c > b ? b : c);
    return (uint8_t)v;
}

// slice row ranges: [H*s/slices, H*(s+1)/slices) with the end rounded
// down to even for the 4:2:0 luma plane.
inline void uly_slice_rows(int64_t H, int slices, int even_mask,
                           int64_t* starts, int64_t* ends) {
    const int64_t mask = even_mask ? ~(int64_t)1 : ~(int64_t)0;
    int64_t send = 0;
    for (int s = 0; s < slices; ++s) {
        starts[s] = send;
        send = (H * (s + 1) / slices) & mask;
        ends[s] = send;
    }
}

void uly_restore_gradient(uint8_t* p, int64_t W, int64_t sstart,
                          int64_t send) {
    if (send <= sstart) return;
    uint8_t* row = p + sstart * W;
    uint8_t acc = (uint8_t)(row[0] + 0x80);
    row[0] = acc;
    for (int64_t i = 1; i < W; ++i) {
        acc = (uint8_t)(acc + row[i]);
        row[i] = acc;
    }
    for (int64_t r = sstart + 1; r < send; ++r) {
        row = p + r * W;
        const uint8_t* top = row - W;
        row[0] = (uint8_t)(row[0] + top[0]);
        for (int64_t i = 1; i < W; ++i)
            row[i] = (uint8_t)(top[i] - top[i - 1] + row[i - 1] + row[i]);
    }
}

void uly_restore_median(uint8_t* p, int64_t W, int64_t sstart,
                        int64_t send) {
    if (send <= sstart) return;
    uint8_t* row = p + sstart * W;
    uint8_t acc = (uint8_t)(row[0] + 0x80);
    row[0] = acc;
    for (int64_t i = 1; i < W; ++i) {
        acc = (uint8_t)(acc + row[i]);
        row[i] = acc;
    }
    if (send - sstart <= 1) return;
    row = p + (sstart + 1) * W;
    const uint8_t* top = row - W;
    int c = top[0];
    int a = (row[0] + c) & 0xFF;
    row[0] = (uint8_t)a;
    for (int64_t i = 1; i < W; ++i) {
        const int b = top[i];
        a = (row[i] + uly_mid_pred(a, b, (a + b - c) & 0xFF)) & 0xFF;
        row[i] = (uint8_t)a;
        c = b;
    }
    int lt = top[W - 1];
    for (int64_t r = sstart + 2; r < send; ++r) {
        row = p + r * W;
        top = row - W;
        for (int64_t i = 0; i < W; ++i) {
            const int t = top[i];
            a = (row[i] + uly_mid_pred(a, t, (a + t - lt) & 0xFF)) & 0xFF;
            row[i] = (uint8_t)a;
            lt = t;
        }
    }
}

}  // namespace ulyns

int uly_decode_plane(const uint8_t* data, int64_t n, int64_t pos,
                     int64_t W, int64_t H, int32_t slices, int32_t pred,
                     int32_t even_mask, uint8_t* out) {
    using namespace ulyns;
    enum { P_NONE = 0, P_LEFT = 1, P_GRADIENT = 2, P_MEDIAN = 3 };
    if (W <= 0 || H <= 0 || slices <= 0 || slices > 256 || pos < 0 ||
        n - pos < 256 + 4 * (int64_t)slices)
        return -1;
    thread_local UlyVlc vlc;
    const int brc = vlc.build(data + pos);
    if (brc) return brc;
    const uint8_t* ends_p = data + pos + 256;
    const int64_t dstart = pos + 256 + 4 * (int64_t)slices;
    int64_t sstarts[256], sends[256];
    uly_slice_rows(H, slices, even_mask, sstarts, sends);
    if (vlc.fsym >= 0) {
        if (pred == P_LEFT) {
            for (int s = 0; s < slices; ++s) {
                int prev = 0x80;
                for (int64_t r = sstarts[s]; r < sends[s]; ++r) {
                    uint8_t* row = out + r * W;
                    for (int64_t i = 0; i < W; ++i) {
                        prev = (prev + vlc.fsym) & 0xFF;
                        row[i] = (uint8_t)prev;
                    }
                }
            }
        } else {
            for (int s = 0; s < slices; ++s)
                if (sends[s] > sstarts[s])
                    memset(out + sstarts[s] * W, vlc.fsym,
                           (size_t)((sends[s] - sstarts[s]) * W));
            if (pred == P_GRADIENT)
                for (int s = 0; s < slices; ++s)
                    uly_restore_gradient(out, W, sstarts[s], sends[s]);
            else if (pred == P_MEDIAN)
                for (int s = 0; s < slices; ++s)
                    uly_restore_median(out, W, sstarts[s], sends[s]);
        }
        return 0;
    }
    int64_t start = 0;
    for (int s = 0; s < slices; ++s) {
        const int64_t end = (int64_t)ends_p[s * 4]
            | ((int64_t)ends_p[s * 4 + 1] << 8)
            | ((int64_t)ends_p[s * 4 + 2] << 16)
            | ((int64_t)ends_p[s * 4 + 3] << 24);
        if (end < start || dstart + end > n) return -3;
        if (sends[s] > sstarts[s] && end == start) return -3;
        const uint8_t* sd = data + dstart + start;
        const int64_t size = end - start;
        const int64_t n_bits = ((size + 3) / 4) * 32;
        // libavcodec zero-pads the slice buffer past its own bytes
        const int64_t avail = size < n - (dstart + start)
            ? size : n - (dstart + start);
        int64_t bitpos = 0;
        int prev = 0x80;
        const int use_left = pred == P_LEFT;
        for (int64_t r = sstarts[s]; r < sends[s]; ++r) {
            uint8_t* row = out + r * W;
            for (int64_t i = 0; i < W; ++i) {
                uint32_t v = 0;
                int sym = -1;
                for (int l = 1; l <= vlc.max_len; ++l) {
                    if (bitpos >= n_bits) return -2;
                    const int64_t wi = bitpos >> 5;
                    const int64_t b0 = wi * 4;
                    const uint32_t word =
                        (b0 < avail ? (uint32_t)sd[b0] : 0)
                        | (b0 + 1 < avail ? (uint32_t)sd[b0 + 1] << 8 : 0)
                        | (b0 + 2 < avail ? (uint32_t)sd[b0 + 2] << 16 : 0)
                        | (b0 + 3 < avail ? (uint32_t)sd[b0 + 3] << 24 : 0);
                    v = (v << 1) | ((word >> (31 - (bitpos & 31))) & 1);
                    ++bitpos;
                    if (vlc.cnt[l]) {
                        const int64_t rel = (int64_t)v - (int64_t)vlc.lo[l];
                        if (rel >= 0 && rel < vlc.cnt[l]) {
                            sym = vlc.syms[l][rel];
                            break;
                        }
                    }
                }
                if (sym < 0) return -2;
                if (use_left) {
                    prev = (prev + sym) & 0xFF;
                    row[i] = (uint8_t)prev;
                } else {
                    row[i] = (uint8_t)sym;
                }
            }
        }
        start = end;
    }
    if (pred == P_GRADIENT)
        for (int s = 0; s < slices; ++s)
            uly_restore_gradient(out, W, sstarts[s], sends[s]);
    else if (pred == P_MEDIAN)
        for (int s = 0; s < slices; ++s)
            uly_restore_median(out, W, sstarts[s], sends[s]);
    return 0;
}

// ---------------------------------------------------------------------------
// Frame-parallel batch ingest decode: AVI frames are independent, so
// batch reads fan the per-frame codec decoders across cores (the
// reference decodes serially on libav's own thread,
// ffmpegwrapper.cpp:818; batch captures have no such ordering need).
// Each frame's rc lands in rcs[f]; the caller re-raises per-frame.
// ---------------------------------------------------------------------------
void uly_decode_frames_gray(const uint8_t* data, const int64_t* offs,
                            const int64_t* sizes, int64_t F, int64_t W,
                            int64_t H, int32_t slices, int32_t even_mask,
                            uint8_t* out, int32_t* rcs) {
    #pragma omp parallel for schedule(dynamic)
    for (int64_t f = 0; f < F; ++f) {
        const int64_t sz = sizes[f];
        if (offs[f] < 0) {           // dropped slot: stays black
            rcs[f] = 0;
            memset(out + f * W * H, 0, (size_t)(W * H));
            continue;
        }
        if (sz < 4) { rcs[f] = -1; continue; }
        const uint8_t* d = data + offs[f];
        const int32_t pred =
            (int32_t)((d[sz - 4] | ((uint32_t)d[sz - 3] << 8)
                       | ((uint32_t)d[sz - 2] << 16)
                       | ((uint32_t)d[sz - 1] << 24)) >> 8) & 3;
        rcs[f] = uly_decode_plane(d, sz, 0, W, H, slices, pred,
                                  even_mask, out + f * W * H);
    }
}

void lags_decode_frames_gray(const uint8_t* data, const int64_t* offs,
                             const int64_t* sizes, int64_t F, int64_t W,
                             int64_t H, uint8_t* out, int32_t* rcs) {
    #pragma omp parallel for schedule(dynamic)
    for (int64_t f = 0; f < F; ++f) {
        const int64_t sz = sizes[f];
        uint8_t* dst = out + f * W * H;
        if (offs[f] < 0) {           // dropped slot: stays black
            rcs[f] = 0;
            memset(dst, 0, (size_t)(W * H));
            continue;
        }
        if (sz < 1) { rcs[f] = -1; continue; }
        const uint8_t* d = data + offs[f];
        if (d[0] == 5) {             // FRAME_SOLID_GRAY
            memset(dst, sz > 1 ? d[1] : 0, (size_t)(W * H));
            rcs[f] = 0;
        } else if (d[0] == 10) {     // FRAME_ARITH_YV12, luma at byte 9
            rcs[f] = sz < 11 ? -1
                : lags_decode_plane(d, sz, 9, W, H, dst);
        } else {
            rcs[f] = -5;             // unsupported frame type
        }
    }
}

void hfyu_decode_frames(const uint8_t* data, const int64_t* offs,
                        const int64_t* sizes, int64_t F,
                        const uint8_t* len_y, const uint8_t* len_u,
                        const uint8_t* len_v, int64_t W, int64_t H,
                        uint8_t* out, int32_t* rcs) {
    #pragma omp parallel for schedule(dynamic)
    for (int64_t f = 0; f < F; ++f) {
        if (offs[f] < 0) {           // dropped slot: stays black
            rcs[f] = 0;
            memset(out + f * W * H, 0, (size_t)(W * H));
            continue;
        }
        rcs[f] = hfyu_decode_yuy2(data + offs[f], sizes[f], len_y,
                                  len_u, len_v, W, H, out + f * W * H);
    }
}

// ---------------------------------------------------------------------------
// FFV1 v3 frame decode — native twin of pipeline/ffv1.py Decoder (the
// Python module is the spec; this is the ingest production path — the
// reference decodes FFV1 through libav, ffmpegwrapper.cpp:543).
// Gray/luma-only, 8-bit, both content coders (Golomb-Rice and the
// binary adaptive range coder).  Adaptive per-slice contexts are
// Python-owned arrays passed in and updated in place, so non-keyframe
// carry-over works across calls.  Slices decode OMP-parallel (they
// are independent).  Returns 0 ok; -1 truncated; -2 corrupt stream;
// -3 CRC mismatch; -5 bad slice header.
// ---------------------------------------------------------------------------
namespace ffv1ns {

struct Rac {
    const uint8_t* d;
    int64_t n, pos;
    uint32_t low, range;
    int overread;
    bool err;
    const uint8_t* one;   // [256]
    const uint8_t* zero;  // [256]
    void init(const uint8_t* data, int64_t nbytes,
              const uint8_t* one_t, const uint8_t* zero_t) {
        d = data; n = nbytes;
        low = nbytes >= 2 ? ((uint32_t)data[0] << 8 | data[1]) : 0;
        pos = 2;
        range = 0xFF00;
        overread = 0;
        err = false;
        one = one_t; zero = zero_t;
    }
    int get_rac(uint8_t* state) {
        const uint32_t s = *state;
        const uint32_t r1 = (range * s) >> 8;
        range -= r1;
        int bit;
        if (low < range) {
            *state = zero[s];
            bit = 0;
        } else {
            low -= range;
            range = r1;
            *state = one[s];
            bit = 1;
        }
        if (range < 0x100) {
            range <<= 8;
            low <<= 8;
            if (pos < n) {
                low += d[pos];
                ++pos;
            } else if (++overread > 64) {
                err = true;
            }
        }
        return bit;
    }
    int64_t get_symbol(uint8_t* state, int is_signed) {
        if (get_rac(state + 0)) return 0;
        int e = 0;
        while (get_rac(state + 1 + (e < 9 ? e : 9))) {
            if (++e > 31) { err = true; return 0; }
        }
        int64_t a = 1;
        for (int i = e - 1; i >= 0; --i)
            a += a + get_rac(state + 22 + (i < 9 ? i : 9));
        if (is_signed && get_rac(state + 11 + (e < 10 ? e : 10)))
            return -a;
        return a;
    }
};

struct Bits {
    const uint8_t* d;
    int64_t pos, n;
    bool err;
    int get1() {
        if (pos >= n) { err = true; return 0; }
        const int64_t p = pos++;
        return (d[p >> 3] >> (7 - (p & 7))) & 1;
    }
    int64_t get(int k) {
        int64_t v = 0;
        for (int i = 0; i < k; ++i) v = (v << 1) | get1();
        return v;
    }
};

constexpr uint8_t LOG2_RUN[41] = {
    0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
    4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 17, 18, 19, 20, 21, 22, 23, 24};

inline int64_t ur_golomb(Bits& gb, int k, int limit, int esc_len) {
    int lz = 0;
    while (!gb.get1()) {
        if (gb.err) return 0;
        if (++lz == limit)
            return gb.get(esc_len) + limit - 1;
    }
    return ((int64_t)lz << k) | gb.get(k);
}

inline int64_t sr_golomb(Bits& gb, int k, int limit, int esc_len) {
    const int64_t v = ur_golomb(gb, k, limit, esc_len);
    return (v >> 1) ^ -(v & 1);
}

inline int fold8(int64_t diff) {
    diff &= 0xFF;
    if (diff >= 128) diff -= 256;
    return (int)diff;
}

// vlc state layout: [cc][4] = drift, error_sum, bias, count
inline int get_vlc_symbol(Bits& gb, int32_t* st) {
    int64_t drift = st[0], error_sum = st[1], bias = st[2],
        count = st[3];
    int64_t i = count;
    int k = 0;
    while (i < error_sum) { ++k; i += i; }
    int64_t v = sr_golomb(gb, k, 12, 8);
    if (2 * drift + count < 0) v = ~v;
    const int ret = fold8(v + bias);
    error_sum += v < 0 ? -v : v;
    drift += v;
    if (count == 128) {
        count >>= 1;
        drift >>= 1;
        error_sum >>= 1;
    }
    ++count;
    if (drift <= -count) {
        bias = bias - 1 > -128 ? bias - 1 : -128;
        drift = drift + count > -count + 1 ? drift + count : -count + 1;
    } else if (drift > 0) {
        bias = bias + 1 < 127 ? bias + 1 : 127;
        drift = drift - count < 0 ? drift - count : 0;
    }
    st[0] = (int32_t)drift;
    st[1] = (int32_t)error_sum;
    st[2] = (int32_t)bias;
    st[3] = (int32_t)count;
    return ret;
}

inline int ffv1_mid_pred(int a, int b, int c) {
    if (a > b) { const int t = a; a = b; b = t; }
    return c < a ? a : (c > b ? b : c);
}

// CRC-32 MSB-first, poly 0x04C11DB7, init 0 (AV_CRC_32_IEEE layout)
inline uint32_t ffv1_crc32(const uint8_t* d, int64_t n) {
    static uint32_t tab[256];
    static bool init = false;
    if (!init) {
        for (int i = 0; i < 256; ++i) {
            uint32_t c = (uint32_t)i << 24;
            for (int j = 0; j < 8; ++j)
                c = (c & 0x80000000u) ? (c << 1) ^ 0x04C11DB7u : c << 1;
            tab[i] = c;
        }
        init = true;
    }
    uint32_t crc = 0;
    for (int64_t i = 0; i < n; ++i)
        crc = (crc << 8) ^ tab[((crc >> 24) ^ d[i]) & 0xFF];
    return crc;
}

struct SliceJob {
    int64_t start, end;
    int rc;
};

}  // namespace ffv1ns

// Persistent state layout (Python-owned, one per stream):
//   slice_qidx  [ns] i32      plane-0 quant index, -1 = uninitialized
//   vlc_states  [ns*max_cc*4] i32
//   rac_states  [ns*max_cc*32] u8
// symbol suffixed _v2 when the micro_version arg was added:
// a stale shipped .so must miss the lookup (clean Python
// fallback), not get called with a mismatched ABI.
int ffv1_decode_frame_gray_v2(
    const uint8_t* data, int64_t n, int64_t W, int64_t H,
    int32_t ac, int32_t ec, int32_t version, int32_t micro,
    int32_t num_h, int32_t num_v,
    const int16_t* quant_tables,   // [qt_count][5][256]
    const int32_t* context_counts, // [qt_count]
    int32_t qt_count, int32_t max_cc,
    const uint8_t* one_state,      // [256]
    int32_t seen_keyframe,
    int32_t* slice_qidx, int32_t* vlc_states, uint8_t* rac_states,
    int32_t* keyframe_out, uint8_t* out) {
    using namespace ffv1ns;
    if (n < 4 || version < 2) return -1;
    uint8_t zero_state[256] = {0};
    for (int i = 1; i < 255; ++i)
        zero_state[i] = (uint8_t)(256 - one_state[256 - i]);
    const int ns = num_h * num_v;
    if (ns <= 0 || ns > 256) return -5;
    // keyframe bit
    Rac main_c;
    main_c.init(data, n, one_state, zero_state);
    uint8_t keystate = 128;
    const int keyframe = main_c.get_rac(&keystate);
    *keyframe_out = keyframe;
    if (!keyframe && !seen_keyframe) return -2;
    // walk slice trailers from the end
    const int trailer = version > 2 ? 3 + 5 * (ec ? 1 : 0) : 0;
    SliceJob jobs[256];
    {
        int64_t pos_end = n;
        for (int i = ns - 1; i >= 0; --i) {
            int64_t v;
            if (version > 2) {
                if (pos_end - trailer < 0) return -1;
                const uint8_t* t = data + pos_end - trailer;
                v = ((int64_t)t[0] << 16 | (int64_t)t[1] << 8 | t[2])
                    + trailer;
            } else {
                v = pos_end;
            }
            const int64_t start = pos_end - v;
            if (start < 0) return -1;
            if (ec && ffv1_crc32(data + start, pos_end - start) != 0)
                return -3;
            jobs[i].start = start;
            jobs[i].end = pos_end;
            jobs[i].rc = 0;
            pos_end = start;
        }
    }
    #pragma omp parallel for schedule(dynamic)
    for (int i = 0; i < ns; ++i) {
        SliceJob& j = jobs[i];
        Rac c;
        if (i == 0) {
            c = main_c;
            c.n = j.end;      // slice 0 continues after the key bit
        } else {
            c.init(data + j.start, j.end - j.start, one_state,
                   zero_state);
        }
        uint8_t state[32];
        memset(state, 128, sizeof(state));
        const int64_t sx = c.get_symbol(state, 0);
        const int64_t sy = c.get_symbol(state, 0);
        const int64_t sw = c.get_symbol(state, 0) + 1;
        const int64_t sh = c.get_symbol(state, 0) + 1;
        if (c.err || sx < 0 || sy < 0 || sx + sw > num_h ||
            sy + sh > num_v) {
            j.rc = -5;
            continue;
        }
        const int64_t x0 = sx * W / num_h;
        const int64_t y0 = sy * H / num_v;
        const int64_t w = (sx + sw) * W / num_h - x0;
        const int64_t h = (sy + sh) * H / num_v - y0;
        int32_t qidx0 = -1;
        for (int p = 0; p < 2; ++p) {   // plane_count = 2 for gray v3
            const int64_t idx = c.get_symbol(state, 0);
            if (idx < 0 || idx >= qt_count) { j.rc = -5; break; }
            if (p == 0) qidx0 = (int32_t)idx;
        }
        if (j.rc) continue;
        c.get_symbol(state, 0);   // picture structure
        c.get_symbol(state, 0);   // sar num
        c.get_symbol(state, 0);   // sar den
        if (c.err) { j.rc = -2; continue; }
        const int64_t si = sy * num_h + sx;
        int32_t* vst = vlc_states + si * (int64_t)max_cc * 4;
        uint8_t* rst = rac_states + si * (int64_t)max_cc * 32;
        const int32_t cc = context_counts[qidx0];
        if (keyframe || slice_qidx[si] != qidx0) {
            slice_qidx[si] = qidx0;
            for (int64_t k = 0; k < cc; ++k) {
                vst[k * 4 + 0] = 0;
                vst[k * 4 + 1] = 4;
                vst[k * 4 + 2] = 0;
                vst[k * 4 + 3] = 1;
            }
            memset(rst, 128, (size_t)cc * 32);
        }
        const int16_t* qt = quant_tables + (int64_t)qidx0 * 5 * 256;
        const int16_t* q0 = qt;
        const int16_t* q1 = qt + 256;
        const int16_t* q2 = qt + 512;
        const int16_t* q3 = qt + 768;
        const int16_t* q4 = qt + 1024;
        const bool five = q3[127] || q4[127];
        std::vector<int32_t> bufa(w + 6, 0), bufb(w + 6, 0);
        int32_t* above = bufa.data() + 3;
        int32_t* cur = bufb.data() + 3;
        Bits gb{nullptr, 0, 0, false};
        if (!ac) {
            // v3.2+ header rac terminator bit, then golomb content
            // (libavcodec gate: (version == 3 && micro > 1) ||
            // version > 3; c.pos counts from j.start for i>0, and
            // from the packet start — where j.start == 0 — for
            // slice 0)
            if ((version == 3 && micro > 1) || version > 3) {
                uint8_t s129 = 129;
                c.get_rac(&s129);
            }
            // c.pos counts from j.start either way (slice 0 has
            // j.start == 0 and its rac spans the whole packet)
            const int64_t gstart = (i == 0 ? 0 : j.start) + c.pos - 1;
            gb.d = data + gstart;
            gb.n = (j.end - gstart) * 8;
            gb.pos = 0;
        }
        int64_t run_index = 0;
        for (int64_t y = 0; y < h && !j.rc; ++y) {
            int32_t* t = above; above = cur; cur = t;
            cur[-1] = above[0];
            above[w] = above[w - 1];
            int run_mode = 0;
            int64_t run_count = 0;
            for (int64_t x = 0; x < w; ++x) {
                const int L = cur[x - 1];
                const int LT = above[x - 1];
                const int T = above[x];
                const int RT = above[x + 1];
                int64_t context;
                if (five) {
                    const int LL = cur[x - 2];
                    const int TT = cur[x];   // two rows up (buffer reuse)
                    context = q0[(L - LT) & 0xFF] + q1[(LT - T) & 0xFF]
                        + q2[(T - RT) & 0xFF] + q3[(LL - L) & 0xFF]
                        + q4[(TT - T) & 0xFF];
                } else {
                    context = q0[(L - LT) & 0xFF] + q1[(LT - T) & 0xFF]
                        + q2[(T - RT) & 0xFF];
                }
                int sign = 0;
                if (context < 0) { context = -context; sign = 1; }
                int64_t diff;
                if (ac) {
                    diff = c.get_symbol(rst + context * 32, 1);
                    if (c.err) { j.rc = -2; break; }
                } else {
                    if (context == 0 && run_mode == 0) run_mode = 1;
                    if (run_mode) {
                        if (run_count == 0 && run_mode == 1) {
                            if (gb.get1()) {
                                run_count =
                                    (int64_t)1 << LOG2_RUN[run_index];
                                if (x + run_count <= w) ++run_index;
                            } else {
                                if (LOG2_RUN[run_index])
                                    run_count =
                                        gb.get(LOG2_RUN[run_index]);
                                else
                                    run_count = 0;
                                if (run_index) --run_index;
                                run_mode = 2;
                            }
                        }
                        --run_count;
                        if (run_count < 0) {
                            run_mode = 0;
                            run_count = 0;
                            diff = get_vlc_symbol(
                                gb, vst + context * 4);
                            if (diff >= 0) ++diff;
                        } else {
                            diff = 0;
                        }
                    } else {
                        diff = get_vlc_symbol(gb, vst + context * 4);
                    }
                    if (gb.err) { j.rc = -2; break; }
                }
                if (sign) diff = -diff;
                const int pred = ffv1_mid_pred(L, T, L + T - LT);
                cur[x] = (int32_t)((pred + diff) & 0xFF);
            }
            if (j.rc) break;
            uint8_t* orow = out + (y0 + y) * W + x0;
            for (int64_t x = 0; x < w; ++x) orow[x] = (uint8_t)cur[x];
        }
    }
    for (int i = 0; i < ns; ++i)
        if (jobs[i].rc) return jobs[i].rc;
    return 0;
}

// Accumulated per-line region histograms (ops/agc.py
// region_histograms twin): line i accumulates pixels[i, lo:hi) over
// ns spans -> out [N,256].  Overlapping spans count once, exactly as
// the numpy mask |= formulation (a per-line pixel mask for ns > 1).
void agc_region_hist(const uint8_t* pixels, int64_t N, int64_t W,
                     const int64_t* lo, const int64_t* hi, int64_t ns,
                     int64_t* out) {
    memset(out, 0, (size_t)N * 256 * sizeof(int64_t));
    thread_local std::vector<uint8_t> mask;
    if (ns > 1 && (int64_t)mask.size() < W) mask.resize((size_t)W);
    for (int64_t i = 0; i < N; ++i) {
        int64_t* h = out + i * 256;
        const uint8_t* px = pixels + i * W;
        if (ns == 1) {
            int64_t a = lo[i], b = hi[i];
            if (a < 0) a = 0;
            if (b > W) b = W;
            for (int64_t p = a; p < b; ++p) ++h[px[p]];
            continue;
        }
        memset(mask.data(), 0, (size_t)W);
        for (int64_t s = 0; s < ns; ++s) {
            int64_t a = lo[s * N + i], b = hi[s * N + i];
            if (a < 0) a = 0;
            if (b > W) b = W;
            if (a < b) memset(&mask[a], 1, (size_t)(b - a));
        }
        for (int64_t p = 0; p < W; ++p)
            if (mask[p]) ++h[px[p]];
    }
}

// Histogram peak search with early-stop window (findBlackWhite
// binarizer.cpp:3235-3330) — native twin of ops/agc.py::_peak_scan.
// hist [N*256] i64; start/stop_limit/min_count/delta [N] i64;
// outputs best [N] i64 (-1 when not found), found [N] u8.
void agc_peak_scan(const int64_t* hist, int64_t N,
                   const int64_t* start, const int64_t* stop_limit,
                   const int64_t* min_count, const int64_t* delta,
                   int32_t upward, int64_t* best, uint8_t* found) {
    for (int64_t n = 0; n < N; ++n) {
        const int64_t* h = hist + n * 256;
        int64_t best_lvl = -1, best_cnt = 0;
        bool ok = false;
        int64_t pos = start[n];
        for (int step = 0; step < 256; ++step) {
            if (upward ? (pos > stop_limit[n]) : (pos < stop_limit[n]))
                break;
            int64_t p = pos < 0 ? 0 : (pos > 255 ? 255 : pos);
            int64_t cnt = h[p];
            if (cnt > best_cnt) {
                best_cnt = cnt;
                if (cnt > min_count[n]) {
                    best_lvl = pos;
                    ok = true;
                }
            }
            if (ok) {
                int64_t dist = pos >= best_lvl ? pos - best_lvl
                                               : best_lvl - pos;
                if (dist >= delta[n]) break;
            }
            pos += upward ? 1 : -1;
        }
        best[n] = best_lvl;
        found[n] = ok;
    }
}

// STC-007 START/STOP marker search over a batch of lines — the native
// twin of ops/markers.py (_search_start_line/_search_stop_line, port of
// searchSTC007Markers binarizer.cpp:5275-5601).  Semantics bit-identical
// to the Python reference; tests assert equality.
//   pixels [N*W] u8; bin_low/bin_high [N] i32; outputs [N] each.
//   stage codes: start 0..4 (BOT_2=4 == found), stop 0..3 (LEN_OK=3).
void stc007_marker_search(
    const uint8_t* pixels, int64_t N, int64_t W,
    const int32_t* bin_low, const int32_t* bin_high,
    int32_t mark_start_max, int32_t mark_end_min, int32_t ppb,
    int32_t limit, uint8_t* st_found, uint8_t* ed_found,
    int64_t* dstart, int64_t* dstop, int64_t* sbg, int64_t* sed,
    int64_t* eed) {
    const int64_t lim = limit < W ? limit : W;
    for (int64_t n = 0; n < N; ++n) {
        const uint8_t* px = pixels + n * W;
        const int32_t lo = bin_low[n], hi = bin_high[n];
        // Forward START "1010" walk with bit-length sanity resets.
        int stage = 0;  // MARK_ST_START
        int64_t b1s = 0, b1e = 0, b3s = 0, b3e = 0;
        for (int64_t i = 0; i < lim;) {
            const int32_t v = px[i];
            if (stage == 0) {
                if (i > mark_start_max) break;
                if (v >= lo) { b1s = i; stage = 1; }
            } else if (stage == 1) {
                if (v < lo) { b1e = i; stage = 2; }
            } else if (stage == 2) {
                if (v >= hi) {
                    b3s = i;
                    const int64_t zl = b3s - b1e;
                    if (zl > 2 * ppb || zl < ppb / 2) { stage = 0; continue; }
                    stage = 3;
                }
            } else {  // stage == 3 (TOP_2)
                if (v < hi) {
                    b3e = i;
                    const int64_t ol = b3e - b3s;
                    if (ol > 2 * ppb || ol < ppb / 2) { stage = 0; continue; }
                    stage = 4;
                    break;
                }
            }
            ++i;
        }
        st_found[n] = stage == 4;
        sbg[n] = b1s;
        sed[n] = b3e;
        dstart[n] = 0; dstop[n] = 0; eed[n] = 0; ed_found[n] = 0;
        if (stage != 4) continue;
        dstart[n] = b1e;
        // Backward STOP "01111" walk.
        int est = 0;  // MARK_ED_START
        int64_t ed_s = 0, ed_e = 0;
        const int64_t lo_limit =
            mark_end_min > ppb * 6 ? mark_end_min - (int64_t)ppb * 6 : 0;
        for (int64_t i = W - 1; i > lo_limit; --i) {
            const int32_t v = px[i];
            if (est == 0) {
                if (i < mark_end_min) break;
                if (v >= hi) { ed_e = i + 1; est = 1; }
            } else {  // MARK_ED_TOP
                if (v < hi) {
                    ed_s = i + 1;
                    if ((ed_e - ed_s) >= 2 * ppb) { est = 3; break; }
                    est = 0;
                }
            }
        }
        ed_found[n] = est == 3;
        dstop[n] = ed_s;
        eed[n] = ed_e;
    }
}

// getFieldResolution decode-both-resolutions counter
// (stc007datastitcher.cpp:996-1214): for each resolution, count
// good blocks (valid & can_force & !silent) with a BROKEN decrement
// floored at zero, over contiguous shifts [0, test_size).
// One call replaces four eval round-trips per frame.
void stc007_field_res_counts(const int32_t* line_words,
                             const uint8_t* line_crc, int64_t L,
                             int64_t test_size, int32_t m2,
                             int64_t* c14, int64_t* c16) {
    (void)L;  // rows are bounded by test_size + 112 (caller guarantees)
    for (int mode = 0; mode < 2; ++mode) {
        const bool is14 = mode == 0;
        int64_t c = 0;
        for (int64_t b = 0; b < test_size; ++b) {
            int32_t w14[8];
            uint8_t ch[8];
            for (int i = 0; i < 8; ++i) {
                const int64_t row = b + 16 * i;
                w14[i] = line_words[row * 8 + i];
                ch[i] = line_crc[row * 8 + i];
            }
            BlockResult r;
            if (is14) {
                correct_one(w14, ch, true, 1, 0, 1, &r);
            } else {
                int32_t w16[8];
                uint8_t c16f[8];
                for (int i = 0; i < 7; ++i) {
                    const int64_t row = b + 16 * i;
                    int32_t s = line_words[row * 8 + WORD_Q0];
                    w16[i] = (w14[i] << F1_WORD_OFS)
                           + ((s >> F1_S_OFFSETS[i]) & F1_S_MASK);
                    c16f[i] = ch[i] && line_crc[row * 8 + WORD_Q0];
                }
                w16[7] = 0;
                c16f[7] = 1;
                correct_one(w16, c16f, false, 1, 0, 1, &r);
            }
            const bool broken = r.state == AUD_BROKEN;
            bool bval = true;
            for (int i = 0; i < 6; ++i) bval = bval && r.valid[i];
            const int lim = is14 ? 8 : 7;
            int raw_errs = 0;
            for (int i = 0; i < lim; ++i) raw_errs += !r.lcrc[i];
            const bool can_force =
                !broken && (is14 ? raw_errs <= 1 : raw_errs == 0);
            bool silent = true;
            for (int i = 0; i < 6 && silent; ++i) {
                int16_t s;
                if (is14) {
                    s = expand14(r.w[i], m2);
                } else {
                    int32_t v = r.w[i] & 0xFFFF;
                    if (v >= 0x8000) v -= 0x10000;
                    s = (int16_t)v;
                }
                if (s != 0) silent = false;
            }
            const bool good = bval && can_force && !silent;
            if (good) ++c;
            else if (broken && c > 0) --c;
        }
        *(is14 ? c14 : c16) = c;
    }
}

// PCM-16x0 block decode (ops/pcm16x0_deint.py::decode_blocks twin, port
// of PCM16X0Deinterleaver: P-parity-only correction, order-dependent
// word<->line map, getWordToLine pcm16x0datablock.cpp).
//   sub_words [S*3] i32, sub_crc [S] u8, shifts [B] i64, even [B] u8.
// Outputs: words [B*9] i32, valid/wcrc [B*9] u8, state/stage [B*3] i32,
// samples [B*6] i16, block_valid [B] u8.
namespace {
// odd-order line of (sub-block, word): word 2 (P) always line 1.
inline int line_of_word(bool even, int blk, int word) {
    if (word == 2) return 1;
    static const int odd_map[3][2] = {{2, 0}, {0, 2}, {2, 0}};
    int line = odd_map[blk][word];
    return even ? 2 - line : line;
}
}  // namespace

// Core of the PCM-16x0 block decode: rows[b*3 + line] gives the source
// subline of each of the block's 3 lines (explicit maps let one call
// cover EVERY padding of the EI sweep, batched_ei_padding_stats).
static void pcm16x0_decode_core(
    const int32_t* sub_words, const uint8_t* sub_crc,
    const int64_t* rows, const uint8_t* even_order, int64_t B,
    int32_t en_p, int32_t force_ecc,
    int32_t* words_out, uint8_t* valid_out, uint8_t* wcrc_out,
    int32_t* state_out, int32_t* stage_out, int16_t* samples_out,
    uint8_t* bval_out) {
    for (int64_t b = 0; b < B; ++b) {
        const bool even = even_order[b];
        bool bval = true;
        for (int blk = 0; blk < 3; ++blk) {
            int32_t w[3];
            uint8_t c[3];
            for (int word = 0; word < 3; ++word) {
                const int line = line_of_word(even, blk, word);
                const int64_t row = rows[b * 3 + line];
                w[word] = sub_words[row * 3 + blk];
                c[word] = sub_crc[row];
            }
            uint8_t valid[3] = {c[0], c[1], c[2]};
            int state = 0;  // AUD_ORIG
            int stage = STG_BAD_BLOCK;
            const int err_total = !c[0] + !c[1] + !c[2];
            const int err_audio = !c[0] + !c[1];
            const int32_t sp = w[0] ^ w[1] ^ w[2];
            const int bad_ptr = !c[0] ? 0 : (!c[1] ? 1 : (!c[2] ? 2 : 64));
            if (err_total <= 1) {
                if (en_p && force_ecc) {
                    if (bad_ptr == 2) {
                        stage = STG_NO_CHECK;
                    } else if (sp == 0) {
                        if (bad_ptr < 3) valid[bad_ptr] = 1;
                        stage = STG_DATA_OK;
                    } else if (bad_ptr == 64) {
                        state = 2;  // AUD_BROKEN in the 16x0 enums
                        stage = STG_BAD_BLOCK;
                    } else {  // bad_ptr < 2
                        w[bad_ptr] ^= sp;
                        valid[bad_ptr] = 1;
                        state = 1;  // AUD_FIX_P
                        stage = STG_DATA_OK;
                    }
                } else if (en_p) {
                    if (err_audio == 0) {
                        stage = STG_DATA_OK;
                    } else if (sp == 0) {
                        stage = STG_DATA_OK;
                    } else if (bad_ptr < 2) {
                        w[bad_ptr] ^= sp;
                        valid[bad_ptr] = 1;
                        state = 1;
                        stage = STG_DATA_OK;
                    }
                } else {
                    if (err_audio == 0)
                        stage = force_ecc ? STG_NO_CHECK : STG_DATA_OK;
                }
            }
            if (state == 2) valid[0] = valid[1] = valid[2] = 0;
            for (int word = 0; word < 3; ++word) {
                const int64_t o = (b * 3 + blk) * 3 + word;
                words_out[o] = w[word];
                valid_out[o] = valid[word];
                wcrc_out[o] = c[word];
            }
            state_out[b * 3 + blk] = state;
            stage_out[b * 3 + blk] = stage;
            for (int word = 0; word < 2; ++word) {
                int32_t v = w[word] & 0xFFFF;
                if (v >= 0x8000) v -= 0x10000;
                samples_out[(b * 3 + blk) * 2 + word] = (int16_t)v;
            }
            bval = bval && valid[0] && valid[1];
        }
        bval_out[b] = bval;
    }
}

// Packed per-block flags + output-pass counters over a decode's
// results (the numpy twins: _si_seam_flags and _stream_blocks' stat
// reduces in pipeline/stitcher_pcm16x0.py).  flags bit 0 silent,
// 1 block_valid, 2 fixed_p(any), 3 broken(any), 4 no_check(any).
// counters[4]: sub-blocks with dropped audio words, broken sub-blocks,
// P-fixed sub-blocks, dropped audio words.
void pcm16x0_block_flags(
    const uint8_t* valid, const int32_t* state, const int32_t* stage,
    const int16_t* samples, const uint8_t* bval, int64_t B,
    uint8_t* flags_out, int64_t* counters) {
    for (int i = 0; i < 4; ++i) counters[i] = 0;
    for (int64_t b = 0; b < B; ++b) {
        bool silent = true, fixp = false, broken = false, nochk = false;
        for (int k = 0; k < 6; ++k)
            if (samples[b * 6 + k] != 0) { silent = false; break; }
        for (int blk = 0; blk < 3; ++blk) {
            const int32_t st = state[b * 3 + blk];
            if (st == 1) { fixp = true; ++counters[2]; }
            if (st == 2) { broken = true; ++counters[1]; }
            if (stage[b * 3 + blk] == STG_NO_CHECK) nochk = true;
            const uint8_t v0 = valid[(b * 3 + blk) * 3 + 0];
            const uint8_t v1 = valid[(b * 3 + blk) * 3 + 1];
            if (!(v0 && v1)) ++counters[0];
            counters[3] += !v0 + !v1;
        }
        uint8_t f = 0;
        if (silent) f |= 1;
        if (bval[b]) f |= 2;
        if (fixp) f |= 4;
        if (broken) f |= 8;
        if (nochk) f |= 16;
        flags_out[b] = f;
    }
}

// PCM-16x0 burst counters — native twin of _burst_core's cumsum
// formulation (trySIPadding :1150-1420 / tryEIPadding :2420-2610
// semantics): valid count since the last reset (silence run >=
// max_silence, unchecked run > max_unch, every BROKEN block);
// `broken` totals (SI) or max-runs (EI).  out[4]: vmax, smax, umax, brk.
void pcm16x0_burst_stats(const uint8_t* flags, int64_t B,
                         int32_t max_silence, int32_t max_unch,
                         int32_t broken_as_run, int32_t* out) {
    int64_t run = 0, vmax = 0, sil_run = 0, smax = 0, unch_run = 0,
        umax = 0, brk_cnt = 0, brk_run = 0, brk_max = 0;
    for (int64_t i = 0; i < B; ++i) {
        const uint8_t f = flags[i];
        const bool silent = f & 1, bv = f & 2, fixp = f & 4,
            broken = f & 8, nochk = f & 16;
        const bool valid_b = bv && !silent && !nochk;
        const bool unch = nochk || fixp;
        sil_run = silent ? sil_run + 1 : 0;
        if (sil_run > smax) smax = sil_run;
        unch_run = unch ? unch_run + 1 : 0;
        if (unch_run > umax) umax = unch_run;
        brk_run = broken ? brk_run + 1 : 0;
        if (brk_run > brk_max) brk_max = brk_run;
        if (broken) ++brk_cnt;
        if (!valid_b && run > vmax) vmax = run;
        const bool reset = (silent && sil_run >= max_silence)
            || (unch && unch_run > max_unch) || broken;
        if (reset) run = 0;
        else if (valid_b) ++run;
    }
    if (run > vmax) vmax = run;
    out[0] = (int32_t)vmax;
    out[1] = (int32_t)smax;
    out[2] = (int32_t)umax;
    out[3] = (int32_t)(broken_as_run ? brk_max : brk_cnt);
}

void pcm16x0_decode_blocks(
    const int32_t* sub_words, const uint8_t* sub_crc,
    const int64_t* shifts, const uint8_t* even_order, int64_t B,
    int32_t ofs, int32_t en_p, int32_t force_ecc,
    int32_t* words_out, uint8_t* valid_out, uint8_t* wcrc_out,
    int32_t* state_out, int32_t* stage_out, int16_t* samples_out,
    uint8_t* bval_out) {
    int64_t* rows = new int64_t[B * 3];
    for (int64_t b = 0; b < B; ++b)
        for (int line = 0; line < 3; ++line)
            rows[b * 3 + line] = shifts[b] + (int64_t)line * ofs;
    pcm16x0_decode_core(sub_words, sub_crc, rows, even_order, B, en_p,
                        force_ecc, words_out, valid_out, wcrc_out,
                        state_out, stage_out, samples_out, bval_out);
    delete[] rows;
}

// PCM-1 field deinterleave + 13->16 companding + output stats in one
// pass — twin of ops/pcm1_deint.deinterleave_field + formats/pcm1
// expand_sample (pcm1line.cpp:196-233) + the _deinterleave_field stat
// reduces (pipeline/stitcher_pcm1.py).  Inputs are the assembled
// 735-subline field (caller pads); outputs are the SampleChunk
// ingredients in pair order with the short-block pair dropped.
// counters[2] = (blocks with any invalid pair, invalid pairs).
namespace {
constexpr int P1_BLOCKS = 8, P1_STRIPE = 46, P1_PAIRS = 92;

inline int16_t pcm1_expand1(int64_t word) {
    const uint32_t w = (uint32_t)(word & 0x1FFF);
    uint32_t out;
    if ((w & 0x1000u) == 0) {
        out = (w << 4) & 0xFFFFu;
    } else {
        out = (w & ~0x1000u) << 2;
        if (w & 0x0800u) out |= (1u << 15) | (1u << 14);
        out &= 0xFFFFu;
    }
    return (int16_t)(out >= 0x8000u ? (int32_t)out - 0x10000
                                    : (int32_t)out);
}

// (block, pair) -> subline, -1 for the absent short-block pair
// (pair_to_subline_map twin).
inline int64_t p1_subline(int n, int p) {
    const bool even_stripe = (p % 2) == 1;
    const int wp = p / 2;
    if (n == P1_BLOCKS - 1 && even_stripe && wp >= 45) return -1;
    const int ofs = (((n % 2) == 0) == even_stripe) ? 0 : P1_STRIPE;
    return (int64_t)n * P1_PAIRS + ofs + wp;
}
}  // namespace

void pcm1_field_deint(
    const int64_t* sub_left, const int64_t* sub_right,
    const uint8_t* sub_valid,
    int16_t* samples, uint8_t* valid2, uint8_t* bok, int64_t* counters) {
    counters[0] = counters[1] = 0;
    int64_t o = 0;
    for (int n = 0; n < P1_BLOCKS; ++n) {
        bool block_valid = true;
        for (int p = 0; p < P1_PAIRS; ++p) {
            const int64_t s = p1_subline(n, p);
            if (s >= 0 && !sub_valid[s]) block_valid = false;
        }
        if (!block_valid) ++counters[0];
        for (int p = 0; p < P1_PAIRS; ++p) {
            const int64_t s = p1_subline(n, p);
            if (s < 0) continue;
            const uint8_t v = sub_valid[s];
            samples[o * 2 + 0] = pcm1_expand1(sub_left[s]);
            samples[o * 2 + 1] = pcm1_expand1(sub_right[s]);
            valid2[o * 2 + 0] = v;
            valid2[o * 2 + 1] = v;
            bok[o] = block_valid;
            if (!v) ++counters[1];
            ++o;
        }
    }
}

// ---------------------------------------------------------------------------
// PCM-1 steady frame: trim scan, field split, the auto/manual padding
// math and both field deinterleaves in one call (push_frame,
// pipeline/stitcher_pcm1.py; doFrameReassemble pcm1datastitcher.cpp:
// 1578).  Header-bearing frames (file boundaries: SRV_HEADER anchors +
// emphasis) and file tags defer to the Python path, which the replay
// mirrors exactly otherwise.
// Record (int64[32]): 0 status (0 ok, 1 file tag), 1..14 trim raw,
// 15..18 odd_data/odd_valid/even_data/even_valid (sublines),
// 19/20 odd_ref/even_ref, 21..24 (bad_blocks, samples_drop) per
// emitted field in order.  Outputs: two fields x 735 pair rows packed
// (field order given by order_tff).
int32_t pcm1_steady_frame(
    const int64_t* words, const uint8_t* crcv, const uint8_t* forced_bad,
    const int64_t* frame_number, const int64_t* line_number,
    const int8_t* service, const uint8_t* bw_set, const int64_t* ref_level,
    int64_t S, int64_t frame_no, int32_t order_tff,
    int32_t auto_offset, int32_t preset_odd, int32_t preset_even,
    int16_t* samples_out, uint8_t* wv_out, uint8_t* bok_out,
    int64_t* rec) {
    constexpr int64_t P1_LPF = 245, P1_SUBPF = 735;
    constexpr int64_t P1_MIN_GOOD = P1_LPF * 4 / 5;  // 196
    for (int i = 0; i < 32; ++i) rec[i] = 0;
    int64_t tb[14];
    stc007_trim_scan(line_number, frame_number, service, crcv, forced_bad,
                     bw_set, S, frame_no, 0, tb);
    for (int i = 0; i < 14; ++i) rec[1 + i] = tb[i];
    if (tb[8] || tb[9]) {
        rec[0] = 1;
        return 1;
    }
    // trim facts (the native _find_trim branch incl. manual offsets)
    int64_t top[2] = {0, 0}, bot[2] = {0, 0};  // [even, odd]
    if (!auto_offset) {
        top[1] = preset_odd > 0 ? 2 * preset_odd + 1 : 1;
        top[0] = preset_even > 0 ? 2 * preset_even + 2 : 2;
    }
    for (int p = 0; p < 2; ++p) {
        const int base = p == 0 ? 0 : 4;
        const int good = p == 0 ? 12 : 13;
        const int o = tb[good] > P1_MIN_GOOD ? base : base + 2;
        if (tb[o] >= 0) {
            if (auto_offset) top[p] = line_number[tb[o]];
            bot[p] = line_number[tb[o + 1]];
        }
    }
    // field split (line rows; sublines = 3 words L/R interleaved)
    thread_local std::vector<int64_t> idx_e, idx_o;
    if ((int64_t)idx_e.size() < P1_LPF) {
        idx_e.resize((size_t)P1_LPF);
        idx_o.resize((size_t)P1_LPF);
    }
    int64_t sp[13];
    stc007_split_scan(line_number, frame_number, service, crcv,
                      forced_bad, S, frame_no,
                      top[0], bot[0], !(top[0] == 0 && bot[0] == 0),
                      top[1], bot[1], !(top[1] == 0 && bot[1] == 0),
                      P1_LPF, sp, idx_e.data(), idx_o.data());
    const int64_t ne = sp[3], no_ = sp[9];
    rec[15] = 3 * no_;  // odd_data_lines (sublines)
    rec[17] = 3 * ne;   // even_data_lines
    // per-field valid counts are per SUBLINE (3x the line flag) and
    // the ref averages follow splitFrameToFields' tail.
    for (int p = 0; p < 2; ++p) {
        const int64_t* idx = p == 0 ? idx_e.data() : idx_o.data();
        const int64_t n = p == 0 ? ne : no_;
        int64_t vcnt = 0, vsum = 0, sum = 0;
        for (int64_t k = 0; k < n; ++k) {
            const int64_t r = idx[k];
            sum += ref_level[r];
            if (crcv[r] && !forced_bad[r]) {
                ++vcnt;
                vsum += ref_level[r];
            }
        }
        rec[p == 0 ? 18 : 16] = 3 * vcnt;  // *_valid_lines (sublines)
        rec[p == 0 ? 20 : 19] = vcnt ? vsum / vcnt : (n ? sum / n : 0);
    }
    // padding math (findFramePadding auto/no-header and manual branches)
    int64_t top_pad[2];  // [even, odd] in LINES
    if (auto_offset) {
        top_pad[0] = (P1_SUBPF - rec[17]) / 3;
        top_pad[1] = (P1_SUBPF - rec[15]) / 3;
    } else {
        top_pad[0] = preset_even < 0 ? -preset_even : 0;
        top_pad[1] = preset_odd < 0 ? -preset_odd : 0;
    }
    // assemble + deinterleave both fields in output order
    thread_local std::vector<int64_t> sl, sr;
    thread_local std::vector<uint8_t> sv;
    if ((int64_t)sv.size() < P1_SUBPF) {
        sl.resize((size_t)P1_SUBPF);
        sr.resize((size_t)P1_SUBPF);
        sv.resize((size_t)P1_SUBPF);
    }
    int64_t ofs = 0;
    for (int qi = 0; qi < 2; ++qi) {
        const int p = (qi == 0) == (order_tff != 0) ? 1 : 0;  // odd first
        const int64_t* idx = p == 0 ? idx_e.data() : idx_o.data();
        const int64_t n = p == 0 ? ne : no_;
        const int64_t tp = 3 * std::max<int64_t>(0, top_pad[p]);
        for (int64_t i = 0; i < P1_SUBPF; ++i) {
            sl[i] = 0x1000;  // BIT_RANGE_POS (silent pattern)
            sr[i] = 0x1000;
            sv[i] = 0;
        }
        const int64_t n_copy = std::min(3 * n, P1_SUBPF - tp);
        for (int64_t k = 0; k * 3 < n_copy + 2 && k < n; ++k) {
            const int64_t r = idx[k];
            const uint8_t v = crcv[r] && !forced_bad[r];
            for (int j = 0; j < 3; ++j) {
                const int64_t s = 3 * k + j;
                if (s >= n_copy) break;
                sl[tp + s] = words[r * 6 + 2 * j];
                sr[tp + s] = words[r * 6 + 2 * j + 1];
                sv[tp + s] = v;
            }
        }
        int64_t c2[2];
        pcm1_field_deint(sl.data(), sr.data(), sv.data(),
                         samples_out + ofs * 2, wv_out + ofs * 2,
                         bok_out + ofs, c2);
        rec[21 + 2 * qi] = c2[0];
        rec[22 + 2 * qi] = c2[1];
        ofs += P1_SUBPF;
    }
    return 0;
}

// Row-mapped variant: rows [B, 3] explicit subline indices per block.
void pcm16x0_decode_blocks_rows(
    const int32_t* sub_words, const uint8_t* sub_crc,
    const int64_t* rows, const uint8_t* even_order, int64_t B,
    int32_t en_p, int32_t force_ecc,
    int32_t* words_out, uint8_t* valid_out, uint8_t* wcrc_out,
    int32_t* state_out, int32_t* stage_out, int16_t* samples_out,
    uint8_t* bval_out) {
    pcm16x0_decode_core(sub_words, sub_crc, rows, even_order, B, en_p,
                        force_ecc, words_out, valid_out, wcrc_out,
                        state_out, stage_out, samples_out, bval_out);
}

// ---------------------------------------------------------------------------
// PCM-16x0 steady SI frame: the whole push_frame computation in one
// call — trim scan, field split, false-positive prescan, the
// zero-padding fast path of findSIPadding, queue assembly to the
// SUBLINES_PF grid, the control-bit tally and the output block stream
// (pipeline/stitcher_pcm16x0.py push_frame, port of doFrameReassemble
// pcm16x0datastitcher.cpp:5652).  Python replays the frame-descriptor /
// stats bookkeeping from the record and falls back to the unchanged
// stage logic whenever this returns a bail status, so the fast path
// can only match the slow path bit-for-bit or defer.
// ---------------------------------------------------------------------------
namespace {
constexpr int64_t P16_LPF = 245;
constexpr int64_t P16_SUBPF = P16_LPF * 3;       // 735
constexpr int64_t P16_TRUE = 105;                // SI super-block
constexpr int64_t P16_OFS = 35;                  // SI_OFS
constexpr int32_t P16_MAX_SIL = 34, P16_MAX_UNCH = 34;
constexpr int64_t P16_MIN_GOOD = (P16_LPF * 4 / 5) * 3;  // 588
// ctrl-bit offsets (BIT_*_OFS)
constexpr int P16_BIT_OFS[4] = {0, 3, 6, 9};

struct P16Field {
    std::vector<int32_t> w;      // [n,3]
    std::vector<uint8_t> valid;  // crc_valid (post-prescan)
    std::vector<uint8_t> cb;
    std::vector<int8_t> part;
    std::vector<int64_t> ln, fn;
    std::vector<int8_t> pl, pr;
    int64_t n = 0;
    void fill(const int64_t* words, const uint8_t* crcv,
              const uint8_t* forced, const uint8_t* cbits,
              const int8_t* parts, const int64_t* lna, const int64_t* fna,
              const int8_t* pla, const int8_t* pra,
              const int64_t* idx, int64_t count) {
        n = count;
        if ((int64_t)valid.size() < count) {
            w.resize((size_t)count * 3);
            valid.resize((size_t)count);
            cb.resize((size_t)count);
            part.resize((size_t)count);
            ln.resize((size_t)count);
            fn.resize((size_t)count);
            pl.resize((size_t)count);
            pr.resize((size_t)count);
        }
        for (int64_t k = 0; k < count; ++k) {
            const int64_t r = idx[k];
            for (int i = 0; i < 3; ++i)
                w[k * 3 + i] = (int32_t)words[r * 3 + i];
            valid[k] = crcv[r] && !forced[r];
            cb[k] = cbits[r];
            part[k] = parts[r];
            ln[k] = lna[r];
            fn[k] = fna[r];
            pl[k] = pla[r];
            pr[k] = pra[r];
        }
    }
    // prescanForFalsePosCRCs (:753-836): hits computed on a validity
    // snapshot, applied after — matching the numpy twin's order.
    void prescan() {
        thread_local std::vector<int64_t> hits;
        hits.clear();
        for (int64_t i = 0; i + 2 < n; ++i) {
            if (part[i] != 0 || part[i + 1] != 1 || part[i + 2] != 2)
                continue;
            if (fn[i] != fn[i + 1] || fn[i] != fn[i + 2]) continue;
            if (ln[i] != ln[i + 1] || ln[i] != ln[i + 2]) continue;
            const bool left_only = valid[i] && !valid[i + 1]
                && !valid[i + 2] && pl[i] > 0;
            const bool right_only = !valid[i] && !valid[i + 1]
                && valid[i + 2] && pr[i + 2] > 0;
            if (left_only || right_only) hits.push_back(i);
        }
        for (int64_t h : hits)
            valid[h] = valid[h + 1] = valid[h + 2] = 0;
    }
};

// one SI field queue decode over the group x 35 shift grid; outputs the
// chunk ingredients + flags for the burst walk.  Returns B (blocks).
int64_t p16_grid_decode(const int32_t* qw, const uint8_t* qv, int64_t S,
                        int32_t en_p, std::vector<uint8_t>& flags,
                        int64_t* counters, int16_t* samples_out,
                        uint8_t* wv_out, uint8_t* wf_out,
                        uint8_t* bok_out) {
    const int64_t n_groups = S / P16_TRUE;
    const int64_t B = n_groups * P16_OFS;
    if (B == 0) {
        for (int i = 0; i < 4; ++i) counters[i] = 0;
        return 0;
    }
    thread_local std::vector<int64_t> shifts;
    thread_local std::vector<uint8_t> even;
    thread_local std::vector<int32_t> words;
    thread_local std::vector<uint8_t> valid, wcrc, bval;
    thread_local std::vector<int32_t> state, stage;
    thread_local std::vector<int16_t> smp;
    if ((int64_t)shifts.size() < B) {
        shifts.resize((size_t)B);
        even.resize((size_t)B);
        bval.resize((size_t)B);
    }
    if ((int64_t)words.size() < B * 9) {
        words.resize((size_t)B * 9);
        valid.resize((size_t)B * 9);
        wcrc.resize((size_t)B * 9);
        state.resize((size_t)B * 3);
        stage.resize((size_t)B * 3);
        smp.resize((size_t)B * 6);
    }
    if ((int64_t)flags.size() < B) flags.resize((size_t)B);
    for (int64_t g = 0; g < n_groups; ++g)
        for (int64_t i = 0; i < P16_OFS; ++i) {
            shifts[g * P16_OFS + i] = g * P16_TRUE + i;
            even[g * P16_OFS + i] = (i & 1) == 1;
        }
    pcm16x0_decode_blocks(qw, qv, shifts.data(), even.data(), B,
                          (int32_t)P16_OFS, en_p, 1,
                          words.data(), valid.data(), wcrc.data(),
                          state.data(), stage.data(), smp.data(),
                          bval.data());
    pcm16x0_block_flags(valid.data(), state.data(), stage.data(),
                        smp.data(), bval.data(), B, flags.data(),
                        counters);
    if (samples_out) {
        // _stream_blocks output math: per sub-block, broken kills
        // validity; fixed needs the whole block valid.
        for (int64_t b = 0; b < B; ++b) {
            for (int blk = 0; blk < 3; ++blk) {
                const int64_t sb = b * 3 + blk;
                const bool brk = state[sb] == 2;
                const bool bok = bval[b] && !brk;
                bok_out[sb] = bok;
                for (int k = 0; k < 2; ++k) {
                    samples_out[sb * 2 + k] = smp[sb * 2 + k];
                    wv_out[sb * 2 + k] = valid[sb * 3 + k] && !brk;
                    wf_out[sb * 2 + k] = wcrc[sb * 3 + k] && bok;
                }
            }
        }
    }
    return B;
}
}  // namespace

// Record layout (int64[48]):
//  0 status (0 ok; 1 file tag; 2 pad0 fast path failed)
//  1..14 trim scan raw, 15..27 split scan raw,
//  28..35 ctrl tally (emph_cnt, emph_votes, rate_c, rate_v, mode_c,
//         mode_v, code_c, code_v),
//  36/37 queue lengths, 38 blocks_total (3x decoded blocks),
//  39..42 counters (drop, broken, fix_p, samples_drop, both queues),
//  43/44 per-queue output row counts (B*3 each; queue 2 follows
//  queue 1 in the packed output arrays).
int32_t pcm16x0_steady_frame(
    const int64_t* words, const uint8_t* crcv, const uint8_t* forced_bad,
    const int64_t* frame_number, const int64_t* line_number,
    const int8_t* line_part, const int8_t* service,
    const uint8_t* control_bit, const uint8_t* bw_set,
    const int8_t* picked_left, const int8_t* picked_right,
    int64_t S, int64_t frame_no, int32_t order_tff, int32_t en_p,
    int64_t* rec, int16_t* samples_out, uint8_t* wv_out,
    uint8_t* wf_out, uint8_t* bok_out) {
    for (int i = 0; i < 48; ++i) rec[i] = 0;
    // 1. trim scan (rule B = bw_set alone; _find_trim)
    int64_t tb[14];
    stc007_trim_scan(line_number, frame_number, service, crcv, forced_bad,
                     bw_set, S, frame_no, 0, tb);
    for (int i = 0; i < 14; ++i) rec[1 + i] = tb[i];
    if (tb[8] || tb[9]) {
        rec[0] = 1;
        return 1;
    }
    int64_t top[2] = {0, 0}, bot[2] = {0, 0};  // [even, odd]
    for (int p = 0; p < 2; ++p) {
        const int base = p == 0 ? 0 : 4;
        const int good = p == 0 ? 12 : 13;
        const int o = tb[good] > P16_MIN_GOOD ? base : base + 2;
        if (tb[o] >= 0) {
            top[p] = line_number[tb[o]];
            bot[p] = line_number[tb[o + 1]];
        }
    }
    // 2. split with explicit row indices
    thread_local std::vector<int64_t> idx_e, idx_o;
    if ((int64_t)idx_e.size() < P16_SUBPF) {
        idx_e.resize((size_t)P16_SUBPF);
        idx_o.resize((size_t)P16_SUBPF);
    }
    int64_t sp[13];
    stc007_split_scan(line_number, frame_number, service, crcv,
                      forced_bad, S, frame_no,
                      top[0], bot[0], !(top[0] == 0 && bot[0] == 0),
                      top[1], bot[1], !(top[1] == 0 && bot[1] == 0),
                      P16_SUBPF, sp, idx_e.data(), idx_o.data());
    for (int i = 0; i < 13; ++i) rec[15 + i] = sp[i];
    // 3. field materialization + prescan
    thread_local P16Field fe, fo;
    fe.fill(words, crcv, forced_bad, control_bit, line_part, line_number,
            frame_number, picked_left, picked_right, idx_e.data(), sp[3]);
    fo.fill(words, crcv, forced_bad, control_bit, line_part, line_number,
            frame_number, picked_left, picked_right, idx_o.data(), sp[9]);
    fe.prescan();
    fo.prescan();
    P16Field* first = order_tff ? &fo : &fe;
    P16Field* second = order_tff ? &fe : &fo;
    // 4. per field: pad-0 fast path of findSIPadding, then queue
    // assembly to the SUBLINES_PF / super-block grid.
    thread_local std::vector<int32_t> q1w, q2w;
    thread_local std::vector<uint8_t> q1v, q2v, q1c, q2c;
    thread_local std::vector<uint8_t> fl;
    int64_t out_ofs = 0;
    for (int qi = 0; qi < 2; ++qi) {
        P16Field* f = qi == 0 ? first : second;
        int64_t cnt4[4];
        // try_si_padding(field, 0)
        (void)p16_grid_decode(f->w.data(), f->valid.data(), f->n, en_p,
                              fl, cnt4, nullptr, nullptr, nullptr,
                              nullptr);
        const int64_t Bt = (f->n / P16_TRUE) * P16_OFS;
        int32_t st4[4] = {0, 0, 0, 0};
        if (Bt)
            pcm16x0_burst_stats(fl.data(), Bt, P16_MAX_SIL, P16_MAX_UNCH,
                                0, st4);
        // try_si_padding's ok allows smax == MAX_BURST_SILENCE_SI, but
        // findSIPadding then takes the SILENCE route for smax >= it —
        // so the steady accept needs the STRICT bound (at exactly 34
        // the machine pads from the stats history instead).
        const bool ok0 = Bt > 0 && st4[3] < 1 && st4[1] < P16_MAX_SIL
            && st4[2] <= P16_MAX_UNCH && st4[0] > 0;
        int64_t padding = 0;
        if (!ok0) {
            // findSIPadding's sweep (trySIPadding per pad 0..34, then
            // the reference's stats sort + accept rules).  The SILENCE
            // and zero-anchor-ambiguity routes defer to the machine.
            thread_local std::vector<int32_t> pw;
            thread_local std::vector<uint8_t> pv;
            const int64_t cap = f->n + 3 * P16_OFS;
            if ((int64_t)pv.size() < cap) {
                pw.resize((size_t)cap * 3);
                pv.resize((size_t)cap);
            }
            int32_t sweep[P16_OFS][4];
            for (int64_t p = 0; p < P16_OFS; ++p) {
                const int64_t pre = 3 * p;
                memset(pw.data(), 0, (size_t)pre * 3 * sizeof(int32_t));
                memset(pv.data(), 0, (size_t)pre);
                memcpy(&pw[(size_t)pre * 3], f->w.data(),
                       (size_t)f->n * 3 * sizeof(int32_t));
                memcpy(&pv[pre], f->valid.data(), (size_t)f->n);
                const int64_t S = pre + f->n;
                int64_t c4[4];
                (void)p16_grid_decode(pw.data(), pv.data(), S, en_p,
                                      fl, c4, nullptr, nullptr,
                                      nullptr, nullptr);
                const int64_t Bp = (S / P16_TRUE) * P16_OFS;
                sweep[p][0] = sweep[p][1] = sweep[p][2] = sweep[p][3] = 0;
                if (Bp)
                    pcm16x0_burst_stats(fl.data(), Bp, P16_MAX_SIL,
                                        P16_MAX_UNCH, 0, sweep[p]);
            }
            // StitchStats sort: broken asc, valid desc, unchecked asc,
            // silent asc, index asc (stable insertion over index order).
            int order[P16_OFS];
            for (int i = 0; i < P16_OFS; ++i) order[i] = i;
            auto less = [&](int a, int b) {
                const int32_t* x = sweep[a];
                const int32_t* y = sweep[b];
                if (x[3] != y[3]) return x[3] < y[3];
                if (x[0] != y[0]) return x[0] > y[0];
                if (x[2] != y[2]) return x[2] < y[2];
                if (x[1] != y[1]) return x[1] < y[1];
                return a < b;
            };
            for (int i = 1; i < P16_OFS; ++i) {
                int v = order[i], j = i;
                while (j > 0 && less(v, order[j - 1])) {
                    order[j] = order[j - 1];
                    --j;
                }
                order[j] = v;
            }
            const int32_t* best = sweep[order[0]];
            const int32_t* second = sweep[order[1]];
            const bool silence = best[1] >= P16_MAX_SIL;
            const bool ambiguous =
                best[2] > P16_MAX_UNCH || best[0] == 0
                || (best[3] > 0 && !(best[3] < second[3]
                                     || best[0] > second[0]));
            if (silence || ambiguous) {
                rec[0] = 2;
                return 2;
            }
            padding = order[0];
        }
        rec[45 + qi] = padding;
        // queue = pad + field + silent filler to the super-block grid
        // (_padded_field prepends the padding sublines)
        const int64_t pre = 3 * padding;
        const int64_t base = pre + f->n;
        int64_t target = base + ((P16_TRUE - base % P16_TRUE) % P16_TRUE);
        if (target < P16_SUBPF) target = P16_SUBPF;
        std::vector<int32_t>& qw = qi == 0 ? q1w : q2w;
        std::vector<uint8_t>& qv = qi == 0 ? q1v : q2v;
        std::vector<uint8_t>& qc = qi == 0 ? q1c : q2c;
        if ((int64_t)qv.size() < target) {
            qw.resize((size_t)target * 3);
            qv.resize((size_t)target);
            qc.resize((size_t)target);
        }
        memset(qw.data(), 0, (size_t)pre * 3 * sizeof(int32_t));
        memset(qv.data(), 0, (size_t)pre);
        memset(qc.data(), 0, (size_t)pre);
        memcpy(&qw[(size_t)pre * 3], f->w.data(),
               (size_t)f->n * 3 * sizeof(int32_t));
        memcpy(&qv[pre], f->valid.data(), (size_t)f->n);
        memcpy(&qc[pre], f->cb.data(), (size_t)f->n);
        if (target > base) {
            memset(&qw[(size_t)base * 3], 0,
                   (size_t)(target - base) * 3 * sizeof(int32_t));
            memset(&qv[base], 0, (size_t)(target - base));
            memset(&qc[base], 0, (size_t)(target - base));
        }
        rec[36 + qi] = target;
        // 5. ctrl-bit tally over this queue (collectCtrlBitStats)
        const int64_t n_blk = target / P16_TRUE;
        for (int64_t k = 0; k < n_blk; ++k) {
            const int64_t base = k * P16_TRUE;
            for (int name = 0; name < 4; ++name) {
                const int64_t i = base + 1 + P16_BIT_OFS[name];
                if (i < target && qv[i]) {
                    ++rec[28 + name * 2];
                    if (!qc[i]) ++rec[28 + name * 2 + 1];
                }
            }
        }
    }
    // 6. stream both queues (ctrl tally first, as in push_frame)
    for (int qi = 0; qi < 2; ++qi) {
        std::vector<int32_t>& qw = qi == 0 ? q1w : q2w;
        std::vector<uint8_t>& qv = qi == 0 ? q1v : q2v;
        const int64_t target = rec[36 + qi];
        int64_t cnt4[4];
        const int64_t B = p16_grid_decode(
            qw.data(), qv.data(), target, en_p, fl, cnt4,
            samples_out + out_ofs * 2, wv_out + out_ofs * 2,
            wf_out + out_ofs * 2, bok_out + out_ofs);
        rec[38] += B * 3;
        for (int i = 0; i < 4; ++i) rec[39 + i] += cnt4[i];
        rec[43 + qi] = B * 3;
        out_ofs += B * 3;
    }
    return 0;
}

// PCM-1 / PCM-16x0 coordinate-sweep fallback (the binarizer's
// findPCM1Coordinates :5601 / findPCM16X0Coordinates :5819 search for
// lines the shared frame coordinates cannot decode) — native twin of
// ops/line_decode_np.py: integer-PPB bit coordinates (pcmline.cpp:
// 249-311, :504-519), Schmitt hysteresis read, per-format CRC, the
// readPCMdata (hyst x shift) grid with ref clipping, swept over a
// (left-delta x right-delta) coordinate grid in the caller's order.
namespace {

constexpr int PIX_SH[5] = {0, 1, -1, 2, -2};

inline uint32_t crc16_feed_serial(uint32_t reg, uint32_t word, int nbits,
                                  bool invert_in) {
    for (int b = nbits - 1; b >= 0; --b) {
        uint32_t inbit = ((word >> b) & 1u) ^ (invert_in ? 1u : 0u);
        const uint32_t top = ((reg >> 15) ^ inbit) & 1u;
        reg = (reg << 1) & 0xFFFFu;
        if (top) reg ^= 0x1021u;
    }
    return reg;
}

// Table-driven CRC-16/CCITT feed: chunked lookups replace the
// bit-serial recurrence (built from it once; the serial form above
// stays as the documented reference and differential-fuzz twin).
// Tk[k][v] = serial CRC of the k-bit value v placed at the top of a
// zero register.
struct CrcChunkTables {
    uint16_t t[9][256];
    CrcChunkTables() {
        for (int k = 1; k <= 8; ++k)
            for (uint32_t v = 0; v < (1u << k); ++v)
                t[k][v] = (uint16_t)crc16_feed_serial(v << (16 - k), 0, k,
                                                      false);
    }
};

inline uint32_t crc16_feed_k(uint32_t reg, uint32_t chunk, int k,
                             const uint16_t* tk) {
    const uint32_t idx = ((reg >> (16 - k)) ^ chunk) & ((1u << k) - 1u);
    return ((reg << k) ^ tk[idx]) & 0xFFFFu;
}

inline uint32_t crc16_feed(uint32_t reg, uint32_t word, int nbits,
                           bool invert_in) {
    static const CrcChunkTables tables;  // C++11 magic static
    if (invert_in) word ^= (nbits >= 32 ? ~0u : ((1u << nbits) - 1u));
    int hi = nbits - 8;
    while (hi > 0) {
        reg = crc16_feed_k(reg, (word >> hi) & 0xFFu, 8, tables.t[8]);
        hi -= 8;
    }
    const int k = hi + 8;  // remaining low chunk, 1..8 bits
    return crc16_feed_k(reg, word & ((1u << k) - 1u), k, tables.t[k]);
}

// One trial: read + pack words + CRC. fmt 0 = pcm1 (6x13b + 16b CRC),
// fmt 1 = pcm16x0 part (3x16b + 16b CRC at part_start in a 193-bit line).
inline bool linegrid_trial(const uint8_t* px, int64_t width, int64_t start,
                           int64_t stop, int ref, int depth, int shift,
                           int fmt, int part, int32_t* words_out,
                           int32_t* crc_read, int32_t* calc) {
    int n_words, word_bits, bits_between, bits_per_line, part_start;
    bool inv;
    if (fmt == 0) {
        n_words = 6; word_bits = 13; bits_between = 94;
        bits_per_line = 94; part_start = 0; inv = true;
    } else {
        n_words = 3; word_bits = 16; bits_between = 193;
        bits_per_line = 193;
        part_start = part == 0 ? 0 : (part == 1 ? 64 : 129); inv = false;
    }
    const int n_bits = n_words * word_bits + 16;
    const int64_t pixels = stop - start;
    const int64_t psm = (pixels * 128 + bits_between / 2) / bits_between;
    const int64_t half = (psm + 1) / 2;
    int rl = ref - depth; if (rl < 1) rl = 1;
    int rh = ref + depth; if (rh > 254) rh = 254;
    const int sh = PIX_SH[shift];
    bool prev = false;
    uint32_t crc_data = 0xFFFF;
    int32_t acc = 0;
    int in_word = 0, wi = 0;
    int32_t read_crc = 0;
    for (int i = 0; i < n_bits; ++i) {
        int bit = i + part_start;
        if (bit > bits_per_line - 1) bit = bits_per_line - 1;
        int64_t p = (bit * psm + half) / 128 + start + sh;
        if (p < 0) p = 0;
        if (p >= width) p = width - 1;
        const int v = px[p];
        // Branchless Schmitt select (the per-pixel data-dependent
        // branch mispredicts ~50% otherwise): both comparisons are
        // cheap setcc, the select compiles to bitwise ops.
        const bool b = (prev & (v >= rh)) | ((!prev) & (v > rl));
        prev = b;
        acc = (acc << 1) | (b ? 1 : 0);
        if (wi < n_words) {
            if (++in_word == word_bits) {
                words_out[wi++] = acc;
                crc_data = crc16_feed(crc_data, (uint32_t)acc, word_bits,
                                      inv);
                acc = 0;
                in_word = 0;
            }
        } else if (++in_word == 16) {
            read_crc = acc;
        }
    }
    words_out[n_words] = read_crc;
    uint32_t c = inv ? ((~crc_data) & 0xFFFFu) : crc_data;
    *calc = (int32_t)c;
    *crc_read = read_crc;
    return (int32_t)c == read_crc;
}

// Precomputed bit-sampling pixel positions for one (coords, shift)
// pair: the integer-PPB coordinate math is per FRAME, not per line —
// hoisting it out of the line loop roughly halves the per-line cost.
// n_bits = n_words*word_bits + 16 (all three formats share the
// words+CRC stream shape).
inline void build_pos(int64_t ds, int64_t de, int64_t W, int bits_between,
                      int bits_per_line, int bit_ofs, int part_start,
                      int n_bits, int shift, int32_t* pos) {
    const int64_t psm = ((de - ds) * 128 + bits_between / 2)
        / bits_between;
    const int64_t half = (psm + 1) / 2;
    const int sh = PIX_SH[shift];
    for (int i = 0; i < n_bits; ++i) {
        int bit = i + bit_ofs + part_start;
        if (bit > bits_per_line - 1) bit = bits_per_line - 1;
        int64_t p = (bit * psm + half) / 128 + ds + sh;
        if (p < 0) p = 0;
        if (p >= W) p = W - 1;
        pos[i] = (int32_t)p;
    }
}

// Generic hysteresis word reader over precomputed positions.
// Returns true when the CRC matches; fills words[n_words] and the read
// CRC at words[n_words].
inline bool read_words_pos(const uint8_t* px, const int32_t* pos,
                           int n_words, int word_bits, bool inv,
                           int rl, int rh, int32_t* words) {
    const int n_bits = n_words * word_bits + 16;
    bool prev = false;
    uint32_t reg = 0xFFFF;
    int32_t acc = 0;
    int in_word = 0, wi = 0;
    int32_t crc_read = 0;
    for (int i = 0; i < n_bits; ++i) {
        const int v = px[pos[i]];
        // Branchless Schmitt select (the per-pixel data-dependent
        // branch mispredicts ~50% otherwise): both comparisons are
        // cheap setcc, the select compiles to bitwise ops.
        const bool b = (prev & (v >= rh)) | ((!prev) & (v > rl));
        prev = b;
        acc = (acc << 1) | (b ? 1 : 0);
        if (wi < n_words) {
            if (++in_word == word_bits) {
                words[wi++] = acc;
                reg = crc16_feed(reg, (uint32_t)acc, word_bits, inv);
                acc = 0;
                in_word = 0;
            }
        } else if (++in_word == 16) {
            crc_read = acc;
        }
    }
    words[n_words] = crc_read;
    const uint32_t c = inv ? ((~reg) & 0xFFFFu) : (reg & 0xFFFFu);
    return (int32_t)c == crc_read;
}


// --- PCM-1 / PCM-16x0 coordinate SEARCH (searchPCM1Data binarizer.cpp
// :4123 / searchPCM16X0Data :4514) — the native twin of
// ops/line_decode_np.search_coordinates: left x right offset grid, per-
// left CRC-collision filtering + pickLevelByCRCStats on the right axis,
// then the same filter + pick on the left axis.  Includes the Bit
// Picker (pickCutBitsUpPCM1 :6116 / ...PCM16X0 :6599) for lines whose
// edge bits are cut off-frame.  Bit-identical to the Python reference
// (tests/test_search_native.py).

// Integer-PPB pixel coordinate of line bit `bit` at shift stage 0.
inline int64_t bit_px(int64_t start, int64_t psm, int64_t half,
                      int bit, int64_t width) {
    int64_t p = (bit * psm + half) / 128 + start;
    if (p < 0) p = 0;
    if (p >= width) p = width - 1;
    return p;
}

// count_cut_bits: how many edge bits collapse onto the line boundary.
inline void count_cut(int64_t start, int64_t stop, int64_t width,
                      int bits_between, int max_left, int max_right,
                      int* left_out, int* right_out) {
    const int64_t psm = ((stop - start) * 128 + bits_between / 2)
        / bits_between;
    const int64_t half = (psm + 1) / 2;
    const int64_t ippb = psm / 128;
    const int64_t h = (ippb + 1) / 2;
    int left = 0;
    int64_t first = 0;
    for (int i = 0; i < max_left; ++i) {
        const int64_t cur = bit_px(start, psm, half, i, width);
        if ((cur - first) >= h) break;
        if (i == 0) first = cur;
        left = i + 1;
    }
    int right = 0;
    first = width - 1;
    for (int i = 0; i < max_right; ++i) {
        const int64_t cur = bit_px(start, psm, half,
                                   bits_between - 1 - i, width);
        if ((first - cur) >= h) break;
        if (i == 0) first = cur;
        right = i + 1;
    }
    *left_out = left;
    *right_out = right;
}

inline int32_t crc_pcm1_words(const int32_t* w6) {
    uint32_t reg = 0xFFFF;
    for (int i = 0; i < 6; ++i)
        reg = crc16_feed(reg, (uint32_t)w6[i], 13, true);
    return (int32_t)((~reg) & 0xFFFFu);
}

inline int32_t crc_pcm16x0_words(const int32_t* w3) {
    uint32_t reg = 0xFFFF;
    for (int i = 0; i < 3; ++i)
        reg = crc16_feed(reg, (uint32_t)w3[i], 16, false);
    return (int32_t)(reg & 0xFFFFu);
}

// One grid-sweep trial entry.
struct SweepEntry {
    bool result;
    int32_t crc;
    int32_t hyst;
    int32_t shift;
    int64_t start, stop;
    int32_t words[8];
    int32_t picked_l, picked_r;
};

// pickCutBitsUpPCM1 (:6116): brute-force the cut edge bits; two valid
// patches = collision = stay invalid.
inline void pick_cut_pcm1(SweepEntry* e, int64_t width, int left_pick,
                          int right_pick) {
    int left_n, right_n;
    count_cut(e->start, e->stop, width, 94, left_pick, right_pick,
              &left_n, &right_n);
    if (left_n == 0 && right_n == 0) return;
    const int32_t lw_clean = e->words[0] & ((1 << (13 - left_n)) - 1);
    const int32_t rc_clean =
        right_n ? (e->words[6] & ~((1 << right_n) - 1) & 0xFFFF)
                : e->words[6];
    int32_t found_w = -1, found_c = -1;
    bool collision = false;
    for (int li = 0; li < (1 << left_n) && !collision; ++li) {
        int32_t test[6];
        for (int k = 0; k < 6; ++k) test[k] = e->words[k];
        test[0] = lw_clean | (li << (13 - left_n));
        const int32_t calc = crc_pcm1_words(test);
        for (int ri = 0; ri < (1 << right_n); ++ri) {
            if (calc == (rc_clean | ri)) {
                if (found_w >= 0) { collision = true; break; }
                found_w = test[0];
                found_c = rc_clean | ri;
            }
        }
        if (right_n == 0 && calc == rc_clean) {
            // covered by the ri==0 iteration above
        }
    }
    if (collision || found_w < 0) return;
    e->words[0] = found_w;
    e->words[6] = found_c;
    e->crc = found_c;
    e->result = true;
    e->picked_l = left_n;
    e->picked_r = right_n;
    e->hyst = (left_n && right_n) ? 0x0E : (right_n ? 0x0D : 0x0C);
}

// pickCutBitsUpPCM16X0 (:6599): PART_LEFT patches word 0 MSBs (unique-
// solution rule); PART_RIGHT re-derives the CRC's cut LSBs.
inline void pick_cut_pcm16x0(SweepEntry* e, int64_t width, int part,
                             int left_pick, int right_pick) {
    int left_n, right_n;
    count_cut(e->start, e->stop, width, 193, left_pick, right_pick,
              &left_n, &right_n);
    if (part == 0 && left_n) {
        const int32_t clean = e->words[0] & ((1 << (16 - left_n)) - 1);
        int32_t found = -1;
        for (int li = 0; li < (1 << left_n); ++li) {
            int32_t test[3] = {clean | (li << (16 - left_n)),
                               e->words[1], e->words[2]};
            if (crc_pcm16x0_words(test) == e->words[3]) {
                if (found >= 0) return;  // collision
                found = test[0];
            }
        }
        if (found < 0) return;
        e->words[0] = found;
        e->result = true;
        e->picked_l = left_n;
        e->hyst = 0x0C;
    } else if (part == 2 && right_n) {
        const int32_t mask = ~((1 << right_n) - 1) & 0xFFFF;
        const int32_t calc = crc_pcm16x0_words(e->words);
        if ((calc & mask) == (e->words[3] & mask)) {
            e->words[3] = calc;
            e->crc = calc;
            e->result = true;
            e->picked_r = right_n;
            e->hyst = 0x0D;
        }
    }
}

// read_pcm_grid at hysteresis depth 0 (the search sweeps use
// SHIFT_STAGES_SAFE shifts only) + Bit Picker on failure.
inline void sweep_trial(const uint8_t* px, int64_t width, int64_t start,
                        int64_t stop, int ref, int black, int white,
                        int fmt, int part, int shift_limit,
                        int left_pick, int right_pick, SweepEntry* e) {
    e->result = false;
    e->start = start;
    e->stop = stop;
    e->picked_l = e->picked_r = 0;
    int32_t crc_read, calc;
    const int rl = ref < 1 ? 1 : ref;
    const int rh = ref > 254 ? 254 : ref;
    int d = 0, s = 0;
    bool valid = false;
    if (rl > black && rh < white) {
        for (int shift = 0; shift <= shift_limit; ++shift) {
            if (linegrid_trial(px, width, start, stop, ref, 0, shift,
                               fmt, part, e->words, &crc_read, &calc)) {
                valid = true;
                s = shift;
                break;
            }
        }
    }
    if (!valid) {
        valid = linegrid_trial(px, width, start, stop, ref, 0, 0, fmt,
                               part, e->words, &crc_read, &calc);
        d = s = 0;
    }
    const int n_words = fmt == 0 ? 6 : 3;
    e->crc = e->words[n_words];
    e->hyst = d;
    e->shift = s;
    e->result = valid;
    if (!valid) {
        if (fmt == 0) pick_cut_pcm1(e, width, left_pick, right_pick);
        else pick_cut_pcm16x0(e, width, part, left_pick, right_pick);
    }
}

// _crc_stats_filter: most frequent CRC (first-seen tiebreak); a rival
// with best <= 2*cnt kills everything; survivors share the modal CRC.
inline int crc_stats_filter(SweepEntry* es, int n) {
    int32_t crcs[64];
    int counts[64];
    int n_crc = 0;
    for (int i = 0; i < n; ++i) {
        if (!es[i].result) continue;
        int j = 0;
        for (; j < n_crc; ++j)
            if (crcs[j] == es[i].crc) { ++counts[j]; break; }
        if (j == n_crc && n_crc < 64) {
            crcs[n_crc] = es[i].crc;
            counts[n_crc++] = 1;
        }
    }
    if (n_crc == 0) return 0;
    int best = 0;
    for (int j = 1; j < n_crc; ++j)
        if (counts[j] > counts[best]) best = j;
    for (int j = 0; j < n_crc; ++j) {
        if (j != best && counts[best] <= 2 * counts[j]) {
            for (int i = 0; i < n; ++i) es[i].result = false;
            return 0;
        }
    }
    int alive = 0;
    for (int i = 0; i < n; ++i) {
        if (es[i].result && es[i].crc != crcs[best]) es[i].result = false;
        else if (es[i].result) ++alive;
    }
    return alive;
}

// pickLevelByCRCStats (:1985-2143) over the entry axis.
inline int pick_by_stats(const SweepEntry* es, int n) {
    int lowd = 0xFF, lows = 0xFF, high_idx = -1;
    for (int i = 0; i < n; ++i) {
        if (!es[i].result || es[i].hyst > 0x0F) continue;
        if (es[i].hyst < lowd
            || (es[i].hyst == lowd && es[i].shift < lows)) {
            lowd = es[i].hyst;
            lows = es[i].shift;
            high_idx = i;
        }
    }
    if (high_idx < 0) return -1;
    int best_lo = high_idx, best_hi = high_idx;
    bool run_open = false;
    int cur_lo = high_idx, cur_hi = high_idx;
    for (int i = high_idx; i < n; ++i) {
        const bool match = es[i].result && es[i].hyst == lowd
            && es[i].shift == lows;
        if (match) {
            if (!run_open) { cur_hi = i; run_open = true; }
            cur_lo = i;
        } else {
            if (run_open && (cur_lo - cur_hi) >= (best_lo - best_hi)) {
                best_lo = cur_lo;
                best_hi = cur_hi;
            }
            run_open = false;
        }
    }
    if (run_open && (cur_lo - cur_hi) >= (best_lo - best_hi)) {
        best_lo = cur_lo;
        best_hi = cur_hi;
    }
    return best_hi + (best_lo - best_hi) / 2;
}

}  // namespace

extern "C" {

// PCM-1 frame-batch decode — host twin of binarize.pcm1_frame_decode
// (generic_frame_decode: depth-major (hyst x shift) lex-first valid
// trial, (0,0) fallback; readPCMdata binarizer.cpp:7695 applies the
// hysteresis sweep to every format, binarizer.h:235-241).  pixels
// strided [F, L, W]; coords/ref/black/white [F].  words_out i32
// [F*L, 6], crc_out i32 [F*L], valid_out u8 [F*L].
void pcm1_binarize_frames(
    const uint8_t* pixels, int64_t F, int64_t L, int64_t W,
    int64_t stride_f, int64_t stride_l, const int32_t* coords,
    const int32_t* ref, const int32_t* black, const int32_t* white,
    int32_t hyst_limit, int32_t shift_limit, int32_t* words_out,
    int32_t* crc_out, uint8_t* valid_out) {
    #pragma omp parallel for schedule(dynamic, 1)
    for (int64_t f = 0; f < F; ++f) {
        int32_t pos[5][110];
        const int64_t ds = coords[2 * f], de = coords[2 * f + 1];
        for (int s = 0; s <= shift_limit; ++s)
            build_pos(ds, de, W, 94, 94, 0, 0, 94, s, pos[s]);
        const int rf = ref[f], bk = black[f], wt = white[f];
        const int rl0 = rf < 1 ? 1 : rf, rh0 = rf > 254 ? 254 : rf;
        for (int64_t l = 0; l < L; ++l) {
            const uint8_t* px = pixels + f * stride_f + l * stride_l;
            const int64_t row = f * L + l;
            int32_t w[7];
            bool ok = false;
            for (int d = 0; d <= hyst_limit && !ok; ++d) {
                const int rl = rf - d < 1 ? 1 : rf - d;
                const int rh = rf + d > 254 ? 254 : rf + d;
                if (rl <= bk || rh >= wt) break;  // monotone clipping
                for (int s = 0; s <= shift_limit; ++s) {
                    if (read_words_pos(px, pos[s], 6, 13, true, rl, rh,
                                       w)) {
                        ok = true;
                        break;
                    }
                }
            }
            if (!ok)
                read_words_pos(px, pos[0], 6, 13, true, rl0, rh0, w);
            for (int k = 0; k < 6; ++k) words_out[row * 6 + k] = w[k];
            crc_out[row] = w[6];
            valid_out[row] = ok;
        }
    }
}

// PCM-16x0 frame-batch decode — twin of binarize.pcm16x0_frame_decode:
// 3 sublines per video line + the 129th control bit (plain threshold,
// strictly > ref, shift stage 0).  words_out i32 [F*L, 3, 3],
// crc_out i32 [F*L, 3], valid_out u8 [F*L, 3], ctrl_out u8 [F*L].
void pcm16x0_binarize_frames(
    const uint8_t* pixels, int64_t F, int64_t L, int64_t W,
    int64_t stride_f, int64_t stride_l, const int32_t* coords,
    const int32_t* ref, const int32_t* black, const int32_t* white,
    int32_t hyst_limit, int32_t shift_limit, int32_t* words_out,
    int32_t* crc_out, uint8_t* valid_out, uint8_t* ctrl_out) {
    static const int PART_START[3] = {0, 64, 129};
    #pragma omp parallel for schedule(dynamic, 1)
    for (int64_t f = 0; f < F; ++f) {
        int32_t pos[3][5][64];
        const int64_t ds = coords[2 * f], de = coords[2 * f + 1];
        for (int part = 0; part < 3; ++part)
            for (int s = 0; s <= shift_limit; ++s)
                build_pos(ds, de, W, 193, 193, 0, PART_START[part], 64,
                          s, pos[part][s]);
        const int rf = ref[f], bk = black[f], wt = white[f];
        const int rl0 = rf < 1 ? 1 : rf, rh0 = rf > 254 ? 254 : rf;
        // control-bit pixel: line bit 128 of the 193-bit layout
        const int64_t psm = ((de - ds) * 128 + 193 / 2) / 193;
        const int64_t half = (psm + 1) / 2;
        const int64_t cpx = bit_px(ds, psm, half, 128, W);
        for (int64_t l = 0; l < L; ++l) {
            const uint8_t* px = pixels + f * stride_f + l * stride_l;
            const int64_t row = f * L + l;
            for (int part = 0; part < 3; ++part) {
                int32_t w[4];
                bool ok = false;
                for (int d = 0; d <= hyst_limit && !ok; ++d) {
                    const int rl = rf - d < 1 ? 1 : rf - d;
                    const int rh = rf + d > 254 ? 254 : rf + d;
                    if (rl <= bk || rh >= wt) break;
                    for (int s = 0; s <= shift_limit; ++s) {
                        if (read_words_pos(px, pos[part][s], 3, 16,
                                           false, rl, rh, w)) {
                            ok = true;
                            break;
                        }
                    }
                }
                if (!ok)
                    read_words_pos(px, pos[part][0], 3, 16, false, rl0,
                                   rh0, w);
                for (int k = 0; k < 3; ++k)
                    words_out[(row * 3 + part) * 3 + k] = w[k];
                crc_out[row * 3 + part] = w[3];
                valid_out[row * 3 + part] = ok;
            }
            ctrl_out[row] = px[cpx] > rf;
        }
    }
}

// Bit Picker for one already-read line (pickCutBitsUpPCM1 :6116 /
// ...PCM16X0 :6599 as the binarizer applies them after a failed CRC
// read): words_in holds the read words + read CRC at index n_words.
// Returns 1 when a unique edge-bit patch validates the line; fills
// words_out (incl. CRC) and picked[2] = (left_n, right_n).
int pcm_pick_cut_line(
    const int32_t* words_in, int64_t width, int64_t start, int64_t stop,
    int32_t fmt, int32_t part, int32_t left_pick, int32_t right_pick,
    int32_t* words_out, int32_t* picked) {
    SweepEntry e;
    e.result = false;
    e.start = start;
    e.stop = stop;
    e.picked_l = e.picked_r = 0;
    const int n_words = fmt == 0 ? 6 : 3;
    for (int k = 0; k <= n_words; ++k) e.words[k] = words_in[k];
    e.crc = words_in[n_words];
    if (fmt == 0) pick_cut_pcm1(&e, width, left_pick, right_pick);
    else pick_cut_pcm16x0(&e, width, part, left_pick, right_pick);
    for (int k = 0; k <= n_words; ++k) words_out[k] = e.words[k];
    picked[0] = e.picked_l;
    picked[1] = e.picked_r;
    return e.result ? 1 : 0;
}

// Full coordinate search for one line.  fmt 0 = pcm1, 1 = pcm16x0 (with
// part 0..2).  out (int64[16]): found, start, stop, crc, hyst, shift,
// picked_l, picked_r, words[0..7].
int pcm_search_coordinates(
    const uint8_t* px, int64_t width, int64_t ds, int64_t de,
    int32_t ref, int32_t black, int32_t white, int32_t fmt, int32_t part,
    int32_t step, int32_t max_ofs, int32_t shift_limit,
    int32_t left_pick, int32_t right_pick, int64_t* out) {
    const int n = 2 * max_ofs + 1;
    const int64_t span = (int64_t)step * max_ofs;
    SweepEntry* rights = new SweepEntry[n];
    SweepEntry* lefts = new SweepEntry[n];
    int nl = 0;
    for (int64_t so = ds - span; so <= ds + span; so += step) {
        int nr = 0;
        for (int64_t eo = de + span; eo >= de - span; eo -= step) {
            sweep_trial(px, width, so, eo, ref, black, white, fmt, part,
                        shift_limit, left_pick, right_pick,
                        &rights[nr++]);
        }
        SweepEntry& L = lefts[nl++];
        if (crc_stats_filter(rights, nr)) {
            const int ridx = pick_by_stats(rights, nr);
            L = rights[ridx];
            L.result = true;
        } else {
            L.result = false;
            L.crc = 0;
            L.hyst = 10;  // HYST_DEPTH_MAX dead-entry marker
            L.shift = 4;
        }
    }
    int found = 0;
    if (crc_stats_filter(lefts, nl)) {
        const int lidx = pick_by_stats(lefts, nl);
        if (lidx >= 0 && lefts[lidx].result) {
            const SweepEntry& e = lefts[lidx];
            out[0] = 1;
            out[1] = e.start;
            out[2] = e.stop;
            out[3] = e.crc;
            out[4] = e.hyst;
            out[5] = e.shift;
            out[6] = e.picked_l;
            out[7] = e.picked_r;
            for (int k = 0; k < 8; ++k) out[8 + k] = e.words[k];
            found = 1;
        }
    }
    if (!found) out[0] = 0;
    delete[] rights;
    delete[] lefts;
    return found;
}

}  // extern "C"

namespace {
}  // namespace

// Sweep (d1, d2) coordinate deltas in caller order, each through the
// (hyst x shift) grid of read_pcm_grid; returns 1 + fills words/sel on
// the first valid trial, else 0 (outputs undefined).
int linegrid_coord_sweep(
    const uint8_t* px, int64_t width, int64_t ds, int64_t de,
    int32_t ref, int32_t black, int32_t white, int32_t fmt, int32_t part,
    const int32_t* d1s, int32_t n1, const int32_t* d2s, int32_t n2,
    int32_t hyst_limit, int32_t shift_limit,
    int32_t* words_out, int32_t* sel_out) {
    int32_t crc_read, calc;
    for (int32_t i1 = 0; i1 < n1; ++i1) {
        for (int32_t i2 = 0; i2 < n2; ++i2) {
            const int64_t s = ds + d1s[i1], e = de + d2s[i2];
            for (int depth = 0; depth <= hyst_limit; ++depth) {
                const int rl = ref - depth < 1 ? 1 : ref - depth;
                const int rh = ref + depth > 254 ? 254 : ref + depth;
                if (rl <= black || rh >= white) break;
                for (int shift = 0; shift <= shift_limit; ++shift) {
                    if (linegrid_trial(px, width, s, e, ref, depth, shift,
                                       fmt, part, words_out, &crc_read,
                                       &calc)) {
                        sel_out[0] = d1s[i1];
                        sel_out[1] = d2s[i2];
                        sel_out[2] = depth;
                        sel_out[3] = shift;
                        return 1;
                    }
                }
            }
            // read_pcm_grid fallback trial (0,0): can only validate when
            // the grid was skipped by ref clipping.
            if (linegrid_trial(px, width, s, e, ref, 0, 0, fmt, part,
                               words_out, &crc_read, &calc)
                && (ref - 0 <= black || ref + 0 >= white)) {
                sel_out[0] = d1s[i1];
                sel_out[1] = d2s[i2];
                sel_out[2] = 0;
                sel_out[3] = 0;
                return 1;
            }
        }
    }
    return 0;
}

// CRC-16/CCITT-FALSE over one line's 8x14-bit words (MSB-first,
// init 0xFFFF, poly 0x1021, non-augmented) — the single-row re-CRC of
// the CWD write-back (patchBrokenLines stc007datastitcher.cpp:5459).
// Verified against formats/stc007.calc_crc and an independent
// transcription (tests/test_external_anchor.py).
uint16_t stc007_crc_row(const int32_t* w8) {
    // 128-entry table: 7 bits per step (14-bit words = 2 steps each);
    // built once from the bit-serial recurrence, which remains the
    // documented reference form (tests pin both against hand-computed
    // vectors, tests/test_external_anchor.py).
    // C++11 magic static: thread-safe one-time build (the batch
    // driver's stitcher pool calls this concurrently with the GIL
    // released; a plain static-bool guard would be a data race).
    struct Crc7Table {
        uint16_t t[128];
        Crc7Table() {
            for (uint32_t v = 0; v < 128; ++v) {
                uint32_t reg = v << 9;
                for (int b = 0; b < 7; ++b) {
                    const uint32_t top = reg & 0x8000u;
                    reg = (reg << 1) & 0xFFFFu;
                    if (top) reg ^= 0x1021u;
                }
                t[v] = (uint16_t)reg;
            }
        }
    };
    static const Crc7Table table;
    const uint16_t* tbl = table.t;
    uint32_t reg = 0xFFFF;
    for (int i = 0; i < 8; ++i) {
        const uint32_t w = (uint32_t)w8[i] & 0x3FFFu;
        reg = ((reg << 7) & 0xFFFFu) ^ tbl[((reg >> 9) ^ (w >> 7)) & 0x7Fu];
        reg = ((reg << 7) & 0xFFFFu) ^ tbl[((reg >> 9) ^ w) & 0x7Fu];
    }
    return (uint16_t)reg;
}

// Batch row CRC: N lines of 8x14-bit words -> N CRCs. Host stitcher
// CRC-validity priming (LineStore.calc_crc); same bitloop as
// stc007_crc_row.
void stc007_crc_rows(const int32_t* words, int64_t n, uint16_t* out) {
    for (int64_t i = 0; i < n; ++i) out[i] = stc007_crc_row(words + 8 * i);
}

// Batch row CRC for the PCM-1 (6x13-bit, inverted scheme) and PCM-16x0
// (3x16-bit plain) stores — the stitchers' validity priming, like
// stc007_crc_rows.
void pcm_crc_rows(const int32_t* words, int64_t n, int32_t n_words,
                  int32_t word_bits, int32_t invert, uint16_t* out) {
    const bool inv = invert != 0;
    for (int64_t i = 0; i < n; ++i) {
        uint32_t reg = 0xFFFF;
        const int32_t* w = words + i * n_words;
        for (int k = 0; k < n_words; ++k)
            reg = crc16_feed(reg, (uint32_t)w[k], word_bits, inv);
        out[i] = (uint16_t)(inv ? ((~reg) & 0xFFFFu) : (reg & 0xFFFFu));
    }
}

// tryPadding burst counters over packed eval flags (:1623-1720).
// out[0..3] = valid_max, silent_max, unchecked_max, broken_count.
void stc007_burst_stats(const uint8_t* flags, int64_t B, int32_t unch_lim,
                        int32_t en_q, int32_t max_burst_silence,
                        int32_t max_burst_broken, int32_t* out) {
    int valid_run = 0, sil_run = 0, unch_run = 0;
    int valid_max = 0, sil_max = 0, unch_max = 0, broken_count = 0;
    for (int64_t i = 0; i < B; ++i) {
        const uint8_t f = flags[i];
        const bool broken = f & 1, bval = f & 2, cforce = f & 4,
                   silent = f & 8, fixp = f & 16, fixq = f & 32;
        const bool valid_b = bval && !silent && cforce;
        const bool unch = en_q ? (!cforce || fixq) : fixp;
        if (valid_b) ++valid_run;
        else if (valid_run > valid_max) valid_max = valid_run;
        if (silent) {
            if (++sil_run >= max_burst_silence) valid_run = 0;
        } else {
            if (sil_run > sil_max) sil_max = sil_run;
            sil_run = 0;
        }
        if (unch) {
            if (++unch_run >= unch_lim) valid_run = 0;
        } else {
            if (unch_run > unch_max) unch_max = unch_run;
            unch_run = 0;
        }
        if (broken) {
            if (++broken_count >= max_burst_broken) valid_run = 0;
        }
    }
    if (valid_run > valid_max) valid_max = valid_run;
    if (sil_run > sil_max) sil_max = sil_run;
    if (unch_run > unch_max) unch_max = unch_run;
    out[0] = valid_max;
    out[1] = sil_max;
    out[2] = unch_max;
    out[3] = broken_count;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// STC-007 trial-grid frame binarizer — host twin of
// ops/binarize.py::stc007_frame_decode (the readPCMdata trial grid,
// binarizer.cpp:7695-8090).  Semantics are bit-identical to the XLA path
// (tests assert equality): integer-PPB bit coordinates (pcmline.cpp:
// 249-311, INT_CALC_MULT=128), Schmitt hysteresis read (fillSTC007
// :7365-7395), CRC-16/CCITT-FALSE over 8x14-bit words, lexicographic
// (hyst, shift) first-valid selection with the (0,0) read as fallback.
//
// The device trial grid evaluates everything at once and argmin-selects;
// this serial twin early-exits like the reference, so a clean line costs
// ONE 128-bit read: the host engine decodes clean lines in place, with
// no pixels sent to a device (the batch driver picks the backend per
// policy).

namespace {

// One (depth, shift) trial of a 128-data-bit STC-007 line.
// Returns true when the CRC matches; fills words[8] + crc_read.
inline bool stc007_trial(const uint8_t* px, int64_t W, int64_t start,
                         int64_t psm, int64_t half, int rl, int rh,
                         int shift, int32_t* words, int32_t* crc_read) {
    const int sh = PIX_SH[shift];
    bool prev = false;
    uint32_t reg = 0xFFFF;
    int32_t acc = 0;
    int in_word = 0, wi = 0;
    for (int i = 0; i < 128; ++i) {
        const int bit = i + 3;  // COORD_BIT_OFS (stc007line.cpp:219-223)
        int64_t p = (bit * psm + half) / 128 + start + sh;
        if (p < 0) p = 0;
        if (p >= W) p = W - 1;
        const int v = px[p];
        // Branchless Schmitt select (the per-pixel data-dependent
        // branch mispredicts ~50% otherwise): both comparisons are
        // cheap setcc, the select compiles to bitwise ops.
        const bool b = (prev & (v >= rh)) | ((!prev) & (v > rl));
        prev = b;
        acc = (acc << 1) | (b ? 1 : 0);
        if (wi < 8) {
            if (++in_word == 14) {
                words[wi++] = acc;
                reg = crc16_feed(reg, (uint32_t)acc, 14, false);
                acc = 0;
                in_word = 0;
            }
        } else if (++in_word == 16) {
            *crc_read = acc;
        }
    }
    return (int32_t)(reg & 0xFFFFu) == *crc_read;
}

}  // namespace

extern "C" {

// Reference-level sweep over a batch of lines — host twin of
// binarize.stc007_ref_sweep_decode (sweepRefLevel binarizer.cpp:3551 /
// calcRefLevelBySweep :3821): per level, the (hyst x shift) grid with
// lex-first-valid selection and the (0,0) read as fallback.  Outputs
// are [R, N] level-major so pick_ref_sweep consumes them unchanged.
void stc007_ref_sweep_lines(
    const uint8_t* pixels, int64_t N, int64_t W, int64_t stride_l,
    const int32_t* coords, const int32_t* black, const int32_t* white,
    const int32_t* levels, int64_t R,
    int32_t hyst_limit, int32_t shift_limit,
    uint8_t* valid_out, int32_t* crc_out, int8_t* hyst_out,
    int8_t* shift_out, int16_t* words_out) {
    #pragma omp parallel for schedule(dynamic, 1)
    for (int64_t n = 0; n < N; ++n) {
        int32_t pos[5][128];
        const uint8_t* px = pixels + n * stride_l;
        const int64_t ds = coords[2 * n], de = coords[2 * n + 1];
        for (int s = 0; s <= shift_limit; ++s)
            build_pos(ds, de, W, 132, 137, 3, 0, 128, s, pos[s]);
        const int bk = black[n], wt = white[n];
        for (int64_t r = 0; r < R; ++r) {
            const int ref = levels[r];
            int32_t w[9];
            int pick_h = -1, pick_s = -1;
            for (int h = 0; h <= hyst_limit && pick_h < 0; ++h) {
                const int rl = ref - h < 1 ? 1 : ref - h;
                const int rh = ref + h > 254 ? 254 : ref + h;
                if (!(rl > bk && rh < wt)) continue;
                for (int s = 0; s <= shift_limit; ++s) {
                    if (read_words_pos(px, pos[s], 8, 14, false, rl, rh,
                                       w)) {
                        pick_h = h;
                        pick_s = s;
                        break;
                    }
                }
            }
            const bool ok = pick_h >= 0;
            if (!ok) {
                const int rl = ref < 1 ? 1 : ref;
                const int rh = ref > 254 ? 254 : ref;
                read_words_pos(px, pos[0], 8, 14, false, rl, rh, w);
                pick_h = 0;
                pick_s = 0;
            }
            const int64_t o = r * N + n;
            valid_out[o] = ok;
            crc_out[o] = w[8];
            hyst_out[o] = (int8_t)pick_h;
            shift_out[o] = (int8_t)pick_s;
            for (int k = 0; k < 8; ++k)
                words_out[o * 8 + k] = (int16_t)w[k];
        }
    }
}

// Frame-batch trial-grid decode.  pixels is a strided [F, L, W] view
// (stride_f/stride_l in BYTES — zero-copy straight off the mmap'd
// capture).  coords [F,2]; ref/black/white are [F] (ref_per_line=0) or
// [F*L] (per-line AGC, findSTC007BW).  Outputs are [F*L] row-major:
// words i16 [F*L,8], crc u16, valid u8, hyst/shift i8.
void stc007_binarize_frames(
    const uint8_t* pixels, int64_t F, int64_t L, int64_t W,
    int64_t stride_f, int64_t stride_l, const int64_t* row_map,
    const int32_t* coords, const int32_t* ref, int32_t ref_per_line,
    const int32_t* black, const int32_t* white,
    int32_t hyst_limit, int32_t shift_limit,
    int16_t* words_out, uint16_t* crc_out, uint8_t* valid_out,
    int8_t* hyst_out, int8_t* shift_out) {
    #pragma omp parallel for schedule(dynamic, 1)
    for (int64_t f = 0; f < F; ++f) {
        int32_t pos[5][128];
        const int64_t ds = coords[2 * f], de = coords[2 * f + 1];
        for (int s = 0; s <= shift_limit; ++s)
            build_pos(ds, de, W, 132, 137, 3, 0, 128, s, pos[s]);
        for (int64_t l = 0; l < L; ++l) {
            // row_map permutes INPUT rows (field-sequential index l ->
            // raw capture row); outputs land at l, so the caller's
            // post-hoc words[:, perm] gathers disappear.
            const int64_t pl = row_map ? row_map[l] : l;
            const uint8_t* px = pixels + f * stride_f + pl * stride_l;
            const int64_t row = f * L + l;
            const int64_t pr = ref_per_line ? f * L + pl : f;
            const int rf = ref[pr], bk = black[pr], wt = white[pr];
            int32_t w[9];
            int pick_h = -1, pick_s = -1;
            for (int h = 0; h <= hyst_limit && pick_h < 0; ++h) {
                const int rl = rf - h < 1 ? 1 : rf - h;
                const int rh = rf + h > 254 ? 254 : rf + h;
                // read_ok gate (fillDataWords binarizer.cpp:7590-7625):
                // clipped hysteresis refs force the trial invalid.
                if (!(rl > bk && rh < wt)) continue;
                for (int s = 0; s <= shift_limit; ++s) {
                    if (read_words_pos(px, pos[s], 8, 14, false, rl, rh,
                                       w)) {
                        pick_h = h;
                        pick_s = s;
                        break;
                    }
                }
            }
            bool ok = pick_h >= 0;
            if (!ok) {
                // Fallback: the (0,0) read (readPCMdata :7957-8010).
                const int rl = rf < 1 ? 1 : rf;
                const int rh = rf > 254 ? 254 : rf;
                read_words_pos(px, pos[0], 8, 14, false, rl, rh, w);
                pick_h = 0;
                pick_s = 0;
            }
            for (int i = 0; i < 8; ++i)
                words_out[row * 8 + i] = (int16_t)w[i];
            crc_out[row] = (uint16_t)w[8];
            valid_out[row] = ok;
            hyst_out[row] = (int8_t)pick_h;
            shift_out[row] = (int8_t)pick_s;
        }
    }
}

// Final-deinterleave block finalization — host twin of the tail of
// stitcher_stc007.performDeinterleave (performDeinterleave
// stc007datastitcher.cpp:6675-6888): seam masking, the post-BROKEN
// countdown windows, markAsUnsafe valid rewrite and the frame stats
// counters, in one pass over the evaluated blocks.
//   flags [B] u8 (eval_rows packed flags), valid/lcrc [B,8] u8,
//   resolution [B] i32 (0=14-bit, 1=16-bit), rows [B,8] i64,
//   line_number/frame_number [L] i64.
//   inner_gate/outer_gate: precomputed (mask_seams && !padding_ok &&
//   !silence) for the inner and outer seam.
// Outputs: out_valid [B,8] u8 (markAsUnsafe applied), wvalid/wfixed
// [B,6] u8, bvalid [B] u8, mask [B] u8, counters [6] i64
// (fix_p, fix_q, fix_cwd, drop, samples_drop, broken_field).
// Returns the updated post-BROKEN countdown.
int32_t stc007_finalize_blocks(
    const uint8_t* flags, const uint8_t* valid, const uint8_t* lcrc,
    const int32_t* resolution, const int64_t* rows,
    const int64_t* line_number, const int64_t* frame_number, int64_t B,
    int64_t start,
    int32_t inner_gate, int32_t outer_gate,
    int64_t fa_frame, int64_t f0_frame, int64_t fb_frame,
    int32_t broken_mask_dur, int32_t countdown_in,
    int32_t file_start, int32_t file_end,
    uint8_t* out_valid, uint8_t* wvalid, uint8_t* wfixed,
    uint8_t* bvalid_out, uint8_t* mask_out, int64_t* counters) {
    for (int i = 0; i < 6; ++i) counters[i] = 0;
    int32_t countdown = countdown_in;
    for (int64_t b = 0; b < B; ++b) {
        const uint8_t f = flags[b];
        const bool broken = f & 1, silent = f & 8;
        const bool fixp = f & 16, fixq = f & 32, cwd_app = f & 64;
        const int last_tap = resolution[b] == 1 ? 6 : 7;
        // rows == NULL: contiguous shifts (block b reads lines
        // start+b, start+b+16, ... start+b+16*7)
        const int64_t r0 = rows ? rows[b * 8 + 0] : start + b;
        const int64_t rl = rows ? rows[b * 8 + last_tap]
                                : start + b + 16 * last_tap;
        // line/frame numbers may be NULL when every consumer of them is
        // off (no seam gates, no file start/end) — the steady-tail path.
        const int64_t sf = frame_number ? frame_number[r0] : 0;
        const int64_t spf = frame_number ? frame_number[rl] : 0;
        const bool on_seam =
            line_number && line_number[r0] > line_number[rl];
        bool unsafe = false;
        if (inner_gate && !silent && on_seam && sf == fa_frame
                && sf == spf)
            unsafe = true;
        if (outer_gate && !silent && sf != spf && sf == f0_frame
                && spf == fa_frame)
            unsafe = true;
        const bool active = !silent && !unsafe;
        // Serial form of the greedy countdown windows: a new window can
        // only start once the previous has fully elapsed.
        if (countdown == 0 && broken_mask_dur > 0 && active && broken)
            countdown = broken_mask_dur;
        bool post = false;
        if (countdown > 0) {
            post = active;
            --countdown;
        }
        const bool mask = unsafe || post;
        mask_out[b] = mask;
        const bool use_lcrc = mask && !broken;
        bool block_valid = true;
        for (int i = 0; i < 8; ++i) {
            const uint8_t v = use_lcrc ? lcrc[b * 8 + i]
                                       : valid[b * 8 + i];
            out_valid[b * 8 + i] = v;
            if (i < 6 && !v) block_valid = false;
        }
        const bool bval = block_valid && !broken;
        bvalid_out[b] = bval;
        for (int i = 0; i < 6; ++i) {
            wvalid[b * 6 + i] = out_valid[b * 8 + i] && !broken;
            wfixed[b * 6 + i] = lcrc[b * 8 + i] && bval;
        }
        const bool rep = !((file_start && sf == f0_frame)
                           || (file_end && spf == fb_frame));
        if (rep) {
            if (block_valid && !mask && fixp) ++counters[0];
            if (block_valid && !mask && fixq) ++counters[1];
            if (block_valid && cwd_app) ++counters[2];
            if (!block_valid) {
                ++counters[3];
                int sd = 0;
                for (int i = 0; i < 6; ++i)
                    sd += !out_valid[b * 8 + i];
                counters[4] += sd;
                if (broken) ++counters[5];
            }
        }
    }
    return countdown;
}

// Frame trim + service scan — host twin of the numpy body of
// find_frames_trim (findFramesTrim stc007datastitcher.cpp:259-737):
// one pass over a frame store finds, per parity, the first/last line
// number carrying PCM (CRC-valid line, or marker-bearing line when the
// field has too few good lines), plus the service-tag facts the pair
// loop needs (new-file/end-file tags, first Control Block line and
// whether it precedes the first good data line).
// The skip_bad threshold pick is left to the caller (it needs
// MIN_GOOD_LINES_PF), so both candidate rules are reported as row
// INDICES (-1 = no hit).  out [14] i64:
// [0..3]  even: firstA, lastA, firstB, lastB
// [4..7]  odd:  firstA, lastA, firstB, lastB
// [8] new_file, [9] end_file, [10] first_cb_index, [11] first_good_index,
// [12] good_even_count, [13] good_odd_count.
// rule_b_or_crc: 1 -> rule B selects (aux | crcv) rows (STC-007: marker
// OR CRC lines); 0 -> rule B selects aux rows alone (PCM-16x0: bw_set).
void stc007_trim_scan(
    const int64_t* line_number, const int64_t* frame_number,
    const int8_t* service, const uint8_t* crcv, const uint8_t* forced_bad,
    const uint8_t* has_markers, int64_t L, int64_t frame_no,
    int32_t rule_b_or_crc, int64_t* out) {
    // service tags (stitcher_stc007.py SRV_*)
    constexpr int8_t SRV_NO = 0, SRV_NEW_FILE = 1, SRV_END_FILE = 2,
        SRV_CTRL_BLOCK = 7;
    int64_t good_cnt[2] = {0, 0};
    // rule A: CRC-valid (ignore forced); rule B: markers OR rule A.
    int64_t firstA[2] = {-1, -1}, lastA[2] = {-1, -1};
    int64_t firstB[2] = {-1, -1}, lastB[2] = {-1, -1};
    int64_t new_file = 0, end_file = 0, first_cb = -1, first_good = -1;
    for (int64_t i = 0; i < L; ++i) {
        if (frame_number[i] != frame_no) continue;
        const int8_t svc = service[i];
        if (svc != SRV_NO) {
            if (svc == SRV_NEW_FILE) new_file = 1;
            else if (svc == SRV_END_FILE) end_file = 1;
            else if (svc == SRV_CTRL_BLOCK && first_cb < 0) first_cb = i;
            continue;
        }
        const int p = (int)(line_number[i] & 1);
        const bool cv = crcv[i] != 0;
        const bool good = cv && !forced_bad[i];
        if (good) {
            ++good_cnt[p];
            if (first_good < 0) first_good = i;
        }
        if (cv) {
            if (firstA[p] < 0) firstA[p] = i;
            lastA[p] = i;
        }
        if (has_markers[i] || (rule_b_or_crc && cv)) {
            if (firstB[p] < 0) firstB[p] = i;
            lastB[p] = i;
        }
    }
    out[0] = firstA[0];  out[1] = lastA[0];
    out[2] = firstB[0];  out[3] = lastB[0];
    out[4] = firstA[1];  out[5] = lastA[1];
    out[6] = firstB[1];  out[7] = lastB[1];
    out[8] = new_file;   out[9] = end_file;
    out[10] = first_cb;  out[11] = first_good;
    out[12] = good_cnt[0];
    out[13] = good_cnt[1];
}

// Field-split scan — host twin of the numpy body of
// split_frames_to_fields (splitFramesToFields
// stc007datastitcher.cpp:737-996): selects, per parity, the data+filler
// rows of the frame inside the trim window [top, bottom], capped at
// `cap` rows.  Most captures yield an evenly-strided row set (parity
// split of interleaved rows), reported as (first, last, step,
// regular=1) so Python can build zero-copy strided views; irregular
// sets fall back to the numpy path.  out [13] i64:
// [0] max_line; per parity p (even base 1, odd base 7):
// first, last, count, step, regular, valid_count.
void stc007_split_scan(
    const int64_t* line_number, const int64_t* frame_number,
    const int8_t* service, const uint8_t* crcv, const uint8_t* forced_bad,
    int64_t L, int64_t frame_no,
    int64_t even_top, int64_t even_bottom, int64_t even_enable,
    int64_t odd_top, int64_t odd_bottom, int64_t odd_enable,
    int64_t cap, int64_t* out,
    int64_t* idx_even_out, int64_t* idx_odd_out) {
    int64_t* idx_out[2] = {idx_even_out, idx_odd_out};
    constexpr int8_t SRV_NO = 0, SRV_FILLER = 3;
    const int64_t top[2] = {even_top, odd_top};
    const int64_t bot[2] = {even_bottom, odd_bottom};
    const int64_t ena[2] = {even_enable, odd_enable};
    int64_t first[2] = {-1, -1}, last[2] = {-1, -1}, count[2] = {0, 0};
    int64_t step[2] = {0, 0}, regular[2] = {1, 1}, valid[2] = {0, 0};
    int64_t max_line = 0;
    bool any = false;
    for (int64_t i = 0; i < L; ++i) {
        if (frame_number[i] != frame_no) continue;
        const int8_t svc = service[i];
        if (svc != SRV_NO && svc != SRV_FILLER) continue;
        const int64_t ln = line_number[i];
        if (!any || ln > max_line) { max_line = ln; any = true; }
        const int p = (int)(ln & 1);
        if (!ena[p] || ln < top[p] || ln > bot[p]) continue;
        if (count[p] >= cap) continue;
        if (first[p] < 0) {
            first[p] = i;
        } else {
            const int64_t gap = i - last[p];
            if (step[p] == 0) step[p] = gap;
            else if (gap != step[p]) regular[p] = 0;
        }
        last[p] = i;
        if (idx_out[p]) idx_out[p][count[p]] = i;
        ++count[p];
        if (crcv[i] && !forced_bad[i]) ++valid[p];
    }
    out[0] = max_line;
    for (int p = 0; p < 2; ++p) {
        int64_t* o = out + 1 + p * 6;
        o[0] = first[p];
        o[1] = last[p];
        o[2] = count[p];
        o[3] = step[p] ? step[p] : 1;
        o[4] = regular[p];
        o[5] = valid[p];
    }
}

// Head-switch duplicate-line detection — host twin of
// v2d.find_duplicate_lines (doBinarize videotodigital.cpp:1210-1260):
// within each field range a VALID line whose data+CRC bits differ from
// the previous valid line by <= thres bits and which is not
// almost-silent (>= 2 of 6 expanded samples within +/-16,
// stc007line.cpp:582-613) marks the LATER line as duplicate.
// words [L,8] i64, crc_read [L] i64, valid [L] u8, bounds [nb,2] i64;
// dup_out [L] u8 must be zeroed by the caller.
void stc007_find_dup_lines(
    const int64_t* words, const int64_t* crc_read, const uint8_t* valid,
    const int64_t* bounds, int64_t nb, int64_t L, int32_t thres,
    int32_t m2, uint8_t* dup_out) {
    (void)L;
    for (int64_t bi = 0; bi < nb; ++bi) {
        const int64_t lo = bounds[2 * bi], hi = bounds[2 * bi + 1];
        int64_t prev = -1;
        for (int64_t r = lo; r < hi; ++r) {
            if (!valid[r]) continue;
            if (prev >= 0) {
                int64_t diff = __builtin_popcountll(
                    (unsigned long long)(crc_read[prev] ^ crc_read[r]));
                for (int k = 0; k < 8; ++k)
                    diff += __builtin_popcountll((unsigned long long)(
                        words[prev * 8 + k] ^ words[r * 8 + k]));
                if (diff <= thres) {
                    int near_silent = 0;
                    for (int i = 0; i < 6; ++i) {
                        const int16_t s = expand14(
                            (int32_t)words[r * 8 + i], m2 != 0);
                        if (s > -16 && s < 16) ++near_silent;
                    }
                    dup_out[r] = near_silent < 2;
                } else {
                    dup_out[r] = 0;
                }
            }
            prev = r;
        }
    }
}

}  // extern "C"
