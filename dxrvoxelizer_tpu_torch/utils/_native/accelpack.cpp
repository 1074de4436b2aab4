// Native host passes of the gen-6 ray-stab accel build: the greedy strip
// packing walk and the voxel -> direction-cell ray table.
//
// The port's copy of the JAX package's dxrvoxelizer_tpu/utils/_native/
// accelpack.cpp (accelpack_run, accelpack_dir_cells, accelpack_raytab_*),
// adapted to the port's walk, ops/raystab_fast._make_packs_py, which takes
// no origin radii: the CSR quadruple is bit-identical to it, and the ray
// table to ops/raystab_fast._ray_table_filled_py (both pinned by
// tests/test_torch_native.py). Not carried over: the capacity-class table
// fills (the TPU's per-step row padding) and the gen-7 tile union (the port
// runs it as torch operations on the card, ops/raystab_tiled.py).
//
// Pack walk contract (the Python walk's):
//  - iterate fine cells in order; skip cells with no candidates or rays;
//  - cells with > 128 rays: flush the pool, emit full 128-lane strips in
//    table order (each cell's rays arrive sorted by origin radius) sharing
//    the cell's bound-sorted unique candidate list, send the tail to the
//    pool;
//  - small cells accumulate in the pool until 128 lanes would overflow;
//  - a flushed pool emits one strip whose candidate list is the
//    bound-sorted unique union of its cells' raw lists;
//  - candidate lists: unique ids ordered by the packed key (tri_bounds'
//    high 40 IEEE-double bits, the id in the low 24) ascending; plain
//    ascending ids when bounds are absent.
//
// Built with -ffp-contract=off (utils/native.py): the cell and radius
// arithmetic must round as numpy's float32 does, with no fused multiply-add.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct AccelPackResult {
    std::vector<int32_t> ray_data;
    std::vector<int64_t> ray_offs;
    std::vector<int64_t> id_data;
    std::vector<int64_t> id_offs;
};

// Direction -> cubemap cell id, bit-identical to
// ops/raystab_fast._dir_cells_host: the same f32 expressions, np.argmax's
// first-max tie rule, the trunc-toward-zero cast.
inline uint32_t dir_cell_one(float x, float y, float z, float half_g,
                             int64_t g, int64_t gg) {
    const float ax = x < 0 ? -x : x;
    const float ay = y < 0 ? -y : y;
    const float az = z < 0 ? -z : z;
    const int a = (ax >= ay) ? (ax >= az ? 0 : 2) : (ay >= az ? 1 : 2);
    const float da = a == 0 ? x : (a == 1 ? y : z);
    const float db = a == 0 ? y : x;  // _OTHERS[a, 0]
    const float dc = a == 2 ? y : z;  // _OTHERS[a, 1]
    const float ada = da < 0 ? -da : da;
    int64_t iu = static_cast<int64_t>((db / ada + 1.0f) * half_g);
    int64_t iv = static_cast<int64_t>((dc / ada + 1.0f) * half_g);
    iu = iu < 0 ? 0 : (iu > g - 1 ? g - 1 : iu);
    iv = iv < 0 ? 0 : (iv > g - 1 ? g - 1 : iv);
    const int64_t f = 2 * a + (da < 0 ? 1 : 0);
    return static_cast<uint32_t>(f * gg + iu * g + iv);
}

// the voxel-centre coordinate ops/packing.voxel_centers_norm gives index i
std::vector<float> centres(int64_t n) {
    std::vector<float> t(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; ++i) {
        t[static_cast<size_t>(i)] =
            (static_cast<float>(i) + 0.5f) / static_cast<float>(n) * 2.0f -
            1.0f;
    }
    return t;
}

struct RaytabState {
    int64_t n, g;
    std::vector<uint32_t> cells;   // per voxel
    std::vector<uint32_t> rbits;   // per voxel: origin-radius f32 bits
    std::vector<int64_t> counts;   // per cell
};

}  // namespace

extern "C" {

// Greedy strip packing over the fine cells' candidate CSR (cell_offs
// [n_cells + 1], cell_data) and the ray table ([n_cells, r_cap], rc rays per
// cell); tri_bounds [max id + 1] f64 or null. -> a handle for the accessors
// below (null when out of memory).
void* accelpack_run(
    const int64_t* cell_offs, const int64_t* cell_data, int64_t n_cells,
    const int32_t* ray_table, int64_t r_cap, const int64_t* rc,
    const double* tri_bounds) {
    auto* res = new (std::nothrow) AccelPackResult();
    if (!res) return nullptr;
    res->ray_offs.push_back(0);
    res->id_offs.push_back(0);

    // the packed sort key per candidate id: one int64 sort + consecutive
    // unique gives the dedupe and the (truncated bound, id) order at once
    int64_t max_id = 0;
    for (int64_t i = cell_offs[0]; i < cell_offs[n_cells]; ++i) {
        max_id = std::max(max_id, cell_data[i]);
    }
    std::vector<uint64_t> key_tab(static_cast<size_t>(max_id + 1));
    for (int64_t t = 0; t <= max_id; ++t) {
        uint64_t hi = 0;
        if (tri_bounds) {
            std::memcpy(&hi, &tri_bounds[t], sizeof(hi));
            hi &= ~uint64_t(0xFFFFFF);
        }
        key_tab[static_cast<size_t>(t)] = hi | static_cast<uint64_t>(t);
    }

    std::vector<int32_t> cur_rays;   // pooled ray lanes
    std::vector<uint64_t> cur_keys;  // pooled candidate keys (with dups)
    std::vector<uint64_t> uniq;      // scratch: sorted unique keys

    auto emit = [&](const int32_t* rays, int64_t nr,
                    const std::vector<uint64_t>& keys) {
        res->ray_data.insert(res->ray_data.end(), rays, rays + nr);
        res->ray_offs.push_back(static_cast<int64_t>(res->ray_data.size()));
        for (uint64_t k : keys) {
            res->id_data.push_back(static_cast<int64_t>(k & 0xFFFFFF));
        }
        res->id_offs.push_back(static_cast<int64_t>(res->id_data.size()));
    };
    auto sort_keys = [](std::vector<uint64_t>& keys) {
        std::sort(keys.begin(), keys.end());
        keys.erase(std::unique(keys.begin(), keys.end()), keys.end());
    };
    auto push_keys = [&](std::vector<uint64_t>& dst, const int64_t* ids,
                         int64_t m) {
        for (int64_t i = 0; i < m; ++i) {
            dst.push_back(key_tab[static_cast<size_t>(ids[i])]);
        }
    };
    auto close = [&]() {
        if (!cur_rays.empty()) {
            uniq = cur_keys;
            sort_keys(uniq);
            emit(cur_rays.data(), static_cast<int64_t>(cur_rays.size()), uniq);
        }
        cur_rays.clear();
        cur_keys.clear();
    };

    for (int64_t c = 0; c < n_cells; ++c) {
        const int64_t beg = cell_offs[c], m = cell_offs[c + 1] - beg;
        const int64_t nray = rc[c];
        if (m == 0 || nray == 0) continue;
        const int32_t* row = ray_table + c * r_cap;
        if (nray > 128) {
            close();
            uniq.clear();
            push_keys(uniq, cell_data + beg, m);
            sort_keys(uniq);
            for (int64_t s = 0; s < nray; s += 128) {
                const int64_t len = std::min<int64_t>(128, nray - s);
                if (len == 128) {
                    emit(row + s, 128, uniq);
                } else {  // tail strip joins the packing pool
                    cur_rays.insert(cur_rays.end(), row + s, row + s + len);
                    push_keys(cur_keys, cell_data + beg, m);
                }
            }
            continue;
        }
        if (static_cast<int64_t>(cur_rays.size()) + nray > 128) close();
        cur_rays.insert(cur_rays.end(), row, row + nray);
        push_keys(cur_keys, cell_data + beg, m);
    }
    close();
    return res;
}

int64_t accelpack_n_packs(void* h) {
    return static_cast<int64_t>(
        static_cast<AccelPackResult*>(h)->ray_offs.size()) - 1;
}

int64_t accelpack_ray_total(void* h) {
    return static_cast<int64_t>(
        static_cast<AccelPackResult*>(h)->ray_data.size());
}

int64_t accelpack_id_total(void* h) {
    return static_cast<int64_t>(
        static_cast<AccelPackResult*>(h)->id_data.size());
}

void accelpack_copy(void* h, int32_t* ray_data, int64_t* ray_offs,
                    int64_t* id_data, int64_t* id_offs) {
    auto* r = static_cast<AccelPackResult*>(h);
    std::copy(r->ray_data.begin(), r->ray_data.end(), ray_data);
    std::copy(r->ray_offs.begin(), r->ray_offs.end(), ray_offs);
    std::copy(r->id_data.begin(), r->id_data.end(), id_data);
    std::copy(r->id_offs.begin(), r->id_offs.end(), id_offs);
}

void accelpack_free(void* h) { delete static_cast<AccelPackResult*>(h); }

// Voxel centre -> direction-cubemap cell id for every voxel of an n^3 grid
// (x-major), fused with the centre generation: _dir_cells_host over the
// grid's voxel_centers_norm, bit for bit.
void accelpack_dir_cells(int64_t n, int64_t g, int64_t* out) {
    const std::vector<float> t = centres(n);
    const float half_g = 0.5f * static_cast<float>(g);
    const int64_t gg = g * g;
    int64_t v = 0;
    for (int64_t i = 0; i < n; ++i) {
        const float x = t[static_cast<size_t>(i)];
        for (int64_t j = 0; j < n; ++j) {
            const float y = -t[static_cast<size_t>(j)];
            for (int64_t k = 0; k < n; ++k, ++v) {
                out[v] = static_cast<int64_t>(dir_cell_one(
                    x, y, t[static_cast<size_t>(k)], half_g, g, gg));
            }
        }
    }
}

// The ray table: each voxel's cell and origin radius (a histogram of the
// cells on the way), then per cell its voxel ids ordered by (radius bits,
// voxel id), by a counting scatter and a sort of each cell's run.
void* accelpack_raytab_start(int64_t n, int64_t g) {
    auto* st = new (std::nothrow) RaytabState();
    if (!st) return nullptr;
    st->n = n;
    st->g = g;
    const int64_t v_total = n * n * n;
    st->cells.resize(static_cast<size_t>(v_total));
    st->rbits.resize(static_cast<size_t>(v_total));
    st->counts.assign(static_cast<size_t>(6 * g * g), 0);
    const std::vector<float> t = centres(n);
    const float half_g = 0.5f * static_cast<float>(g);
    const int64_t gg = g * g;
    int64_t v = 0;
    for (int64_t i = 0; i < n; ++i) {
        const float x = t[static_cast<size_t>(i)];
        for (int64_t j = 0; j < n; ++j) {
            const float y = -t[static_cast<size_t>(j)];
            for (int64_t k = 0; k < n; ++k, ++v) {
                const float z = t[static_cast<size_t>(k)];
                const uint32_t c = dir_cell_one(x, y, z, half_g, g, gg);
                st->cells[static_cast<size_t>(v)] = c;
                // (x^2 + y^2) + z^2 in float32, numpy's order; the bits of
                // a non-negative float order like its value
                const float r = std::sqrt(x * x + y * y + z * z);
                std::memcpy(&st->rbits[static_cast<size_t>(v)], &r,
                            sizeof(float));
                ++st->counts[c];
            }
        }
    }
    return st;
}

// the table's row width: the largest cell, rounded up to 8 (at least 8)
int64_t accelpack_raytab_rcap(void* handle) {
    auto* st = static_cast<RaytabState*>(handle);
    int64_t m = 0;
    for (int64_t c : st->counts) m = m > c ? m : c;
    const int64_t cap = ((m + 7) / 8) * 8;
    return cap < 8 ? 8 : cap;
}

void accelpack_raytab_counts(void* handle, int64_t* rc) {
    auto* st = static_cast<RaytabState*>(handle);
    std::copy(st->counts.begin(), st->counts.end(), rc);
}

// rt: [n_cells, r_cap] int32, voxel ids and -1 padding
void accelpack_raytab_fill(void* handle, int64_t r_cap, int32_t* rt) {
    auto* st = static_cast<RaytabState*>(handle);
    const int64_t n_cells = 6 * st->g * st->g;
    const int64_t v_total = st->n * st->n * st->n;
    std::fill(rt, rt + n_cells * r_cap, int32_t(-1));
    std::vector<int64_t> offs(static_cast<size_t>(n_cells) + 1, 0);
    for (int64_t c = 0; c < n_cells; ++c) {
        offs[static_cast<size_t>(c) + 1] =
            offs[static_cast<size_t>(c)] + st->counts[static_cast<size_t>(c)];
    }
    std::vector<uint64_t> keys(static_cast<size_t>(v_total));
    std::vector<int64_t> pos(offs.begin(), offs.end() - 1);
    for (int64_t v = 0; v < v_total; ++v) {
        const uint32_t c = st->cells[static_cast<size_t>(v)];
        keys[static_cast<size_t>(pos[c]++)] =
            (static_cast<uint64_t>(st->rbits[static_cast<size_t>(v)]) << 32) |
            static_cast<uint64_t>(static_cast<uint32_t>(v));
    }
    for (int64_t c = 0; c < n_cells; ++c) {
        uint64_t* beg = keys.data() + offs[static_cast<size_t>(c)];
        uint64_t* end = keys.data() + offs[static_cast<size_t>(c) + 1];
        std::sort(beg, end);
        int32_t* dst = rt + c * r_cap;
        for (uint64_t* p = beg; p != end; ++p) {
            *dst++ = static_cast<int32_t>(*p & 0xFFFFFFFF);
        }
    }
}

void accelpack_raytab_free(void* handle) {
    delete static_cast<RaytabState*>(handle);
}

}  // extern "C"
