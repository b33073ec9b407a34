"""ReSTIR DI initial-candidate kernel of the port: wrapper, plain version,
counter.

``initial_light_candidates`` replaces ``drts_tpu/ops/restir_pallas.py``'s
``initial_light_candidates`` (B3) with ``csrc/restir.cu``: per pixel, all
``n_l`` ReGIR light-candidate RIS rounds (slot select, light-row fetch,
sphere cone sample, three-lobe BSDF with its mixture pdf, MIS weight,
sequential reservoir update). The uniforms are drawn outside, in the
order of the sequential loop (``ops/restir.initial_sampling``).

What bounds it on the H100: memory. Each pixel reads its 24 surface rows,
4 n_l uniforms and 2 s slot rows once and writes 10 rows; the ~300 float
operations per candidate fit under that. The kernel is one thread per
pixel with the compact light table in shared memory; the TPU kernel's
one-hot matrix-unit row fetch becomes an indexed load. A block's slot rows
are read coalesced into shared memory, so a round's select is a
shared-memory load and not a gather from device memory, and the next
round's uniforms load while a round computes; what a thread keeps across
its rounds but reads rarely (the reservoir's winner, colour, normal and
lobe terms) waits in shared memory too, so seven blocks of 128 threads
fit an SM (``csrc/restir.cu``). ``initial_light_candidates_info`` reads
the kernel's registers, local bytes and resident blocks on the card.

Dispatch is by the tensor's device: a CPU tensor takes the plain version,
which repeats the kernel's arithmetic operation for operation; a CUDA
tensor launches the kernel, or the wrapper raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import backend

PI = math.pi
INV_PI = 1.0 / math.pi
TWO_PI = 2.0 * math.pi

# Surface stream row layout (restir_pallas.ROW_*).
N_SURF_ROWS = 24
(ROW_PX, ROW_PY, ROW_PZ,
 ROW_NX, ROW_NY, ROW_NZ,          # shading normal
 ROW_GX, ROW_GY, ROW_GZ,          # front geometric normal
 ROW_VX, ROW_VY, ROW_VZ,          # view (toward the camera)
 ROW_CR, ROW_CG, ROW_CB,          # base color
 ROW_METAL, ROW_ROUGH, ROW_IORI, ROW_IORO, ROW_TRANS,
 ROW_VALID,
 ROW_WD, ROW_WS, ROW_WT) = range(N_SURF_ROWS)
TABLE_COLS = 9
# The kernel keeps the table in shared memory, at most 48 KB of it (a tile
# of slot rows goes beside it).
MAX_TABLE_ROWS = 48 * 1024 // (4 * TABLE_COLS)


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _normalize3(x, y, z):
    inv = torch.reciprocal(torch.clamp(torch.sqrt(torch.clamp(
        x * x + y * y + z * z, min=0.0)), min=1e-20))
    return x * inv, y * inv, z * inv


def _pow5(x):
    x = torch.clamp(x, 0.0, 1.0)
    x2 = x * x
    return x2 * x2 * x


def initial_light_candidates_plain(surf, uni, slots, table, n_l: int,
                                   s: int, n_b: int):
    """Plain PyTorch B3. surf (24, N) surface stream (ROW_* layout); uni
    (4 n_l, N) uniforms [u_slot u_keep uv0 uv1] per round in draw order;
    slots (2 s, N) the pixel's ReGIR slot rows (candidate compact id as
    f32, then its RIS weight); table (L, 9) compact sphere-light rows.
    Returns (out_f (8, N) f32 [uv0 uv1 phat w_sum dir_xyz dist],
    out_i (2, N) int32 [light_index aux_object_id])."""
    n_lights = table.shape[0]
    (px, py, pz, nx, ny, nz, gx, gy, gz, vx, vy, vz, cr, cg, cb, metal,
     rough, ior_i, ior_o, trans, valid_f, wd, ws, wt) = surf
    del trans  # the lobe weights carry transmission
    valid = valid_f > 0.5

    f_diel = (ior_i - ior_o) / (ior_i + ior_o)
    f_diel = f_diel * f_diel
    f0r = f_diel + (cr - f_diel) * metal
    f0g = f_diel + (cg - f_diel) * metal
    f0b = f_diel + (cb - f_diel) * metal
    alr, alg, alb = cr * (1.0 - metal), cg * (1.0 - metal), cb * (1.0 - metal)

    nov = torch.abs(_dot3(nx, ny, nz, vx, vy, vz))
    is_trans = wt > 0.0
    a_g = rough * rough
    a2_g = a_g * a_g
    g1_v = 2.0 * nov / torch.clamp(
        nov + torch.sqrt(torch.clamp(a2_g + (1.0 - a2_g) * nov * nov,
                                     min=0.0)), min=1e-8)
    m_total = float(n_l + n_b)
    rw = 1.0 - wt
    p5_v = _pow5(1.0 - nov)

    zeros = torch.zeros_like(px)
    res_idx = torch.zeros(px.shape, dtype=torch.int32, device=px.device)
    res_aux = torch.zeros_like(res_idx)
    res_uv0, res_uv1, res_phat, w_sum = zeros, zeros, zeros, zeros
    win_dx, win_dy, win_dz, win_dist = zeros, zeros, zeros, zeros

    for i in range(n_l):
        u_slot, u_keep, uv0, uv1 = uni[4 * i:4 * i + 4]
        slot = torch.clamp((u_slot * float(s)).to(torch.int64), max=s - 1)
        cand_f = torch.gather(slots[:s], 0, slot[None])[0]
        w_cand = torch.gather(slots[s:2 * s], 0, slot[None])[0]
        cand = torch.clamp(cand_f.to(torch.int64), 0, n_lights - 1)
        row = table[cand]                               # (N, 9)
        lcx, lcy, lcz, lrad = row[:, 0], row[:, 1], row[:, 2], row[:, 3]
        em_r, em_g, em_b = row[:, 4], row[:, 5], row[:, 6]
        lpow, laux = row[:, 7], row[:, 8]

        # Cone sampling (light.sample_sphere_light_rows).
        tcx, tcy, tcz = lcx - px, lcy - py, lcz - pz
        dist_c = torch.clamp(torch.sqrt(torch.clamp(
            _dot3(tcx, tcy, tcz, tcx, tcy, tcz), min=0.0)), min=1e-6)
        wx_, wy_, wz_ = tcx / dist_c, tcy / dist_c, tcz / dist_c
        sin_max_sq = lrad / dist_c
        sin_max_sq = torch.clamp(sin_max_sq * sin_max_sq, 0.0, 1.0 - 1e-6)
        cos_max = torch.sqrt(1.0 - sin_max_sq)
        cos_t = 1.0 - uv0 * (1.0 - cos_max)
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        phi = TWO_PI * uv1
        sgn = torch.where(wz_ >= 0, 1.0, -1.0)
        a = -1.0 / (sgn + wz_)
        b = wx_ * wy_ * a
        tx, ty, tz = 1.0 + sgn * wx_ * wx_ * a, sgn * b, -sgn * wx_
        bx, by, bz = b, sgn + wy_ * wy_ * a, -wy_
        sc, ss = sin_t * torch.cos(phi), sin_t * torch.sin(phi)
        ldx = tx * sc + bx * ss + wx_ * cos_t
        ldy = ty * sc + by * ss + wy_ * cos_t
        ldz = tz * sc + bz * ss + wz_ * cos_t
        inv_cone = torch.clamp(TWO_PI * (1.0 - cos_max), min=1e-8)  # 1/pdf
        bq = _dot3(-tcx, -tcy, -tcz, ldx, ldy, ldz)
        cq = _dot3(tcx, tcy, tcz, tcx, tcy, tcz) - lrad * lrad
        disc = torch.clamp(bq * bq - cq, min=0.0)
        ldist = torch.clamp(-bq - torch.sqrt(disc), min=1e-4)

        # Half vector: reflection form, or the refraction form where the
        # transmission lobe is on and L is below the geometric surface.
        hx, hy, hz = _normalize3(ldx + vx, ldy + vy, ldz + vz)
        rx, ry, rz = _normalize3(ldx * ior_o + vx * ior_i,
                                 ldy * ior_o + vy * ior_i,
                                 ldz * ior_o + vz * ior_i)
        flip = _dot3(gx, gy, gz, rx, ry, rz) < 0
        rx = torch.where(flip, -rx, rx)
        ry = torch.where(flip, -ry, ry)
        rz = torch.where(flip, -rz, rz)
        gol = _dot3(gx, gy, gz, ldx, ldy, ldz)
        use_refr = is_trans & (gol < 0)
        hx = torch.where(use_refr, rx, hx)
        hy = torch.where(use_refr, ry, hy)
        hz = torch.where(use_refr, rz, hz)
        nol = torch.abs(_dot3(nx, ny, nz, ldx, ldy, ldz))
        noh = torch.abs(_dot3(nx, ny, nz, hx, hy, hz))
        voh = torch.abs(_dot3(vx, vy, vz, hx, hy, hz))
        front = gol > 0

        f90 = 0.5 + 2.0 * rough * voh * voh
        burley = INV_PI * (1.0 + (f90 - 1.0) * _pow5(1.0 - nol)) \
            * (1.0 + (f90 - 1.0) * p5_v)
        k_diff = torch.where(front, nol * burley * rw, 0.0)
        dterm = noh * noh * (a2_g - 1.0) + 1.0
        d_ggx = a2_g / torch.clamp(PI * dterm * dterm, min=1e-10)
        gv = nol * torch.sqrt(torch.clamp(nov * nov * (1.0 - a2_g) + a2_g,
                                          min=0.0))
        gl = nov * torch.sqrt(torch.clamp(nol * nol * (1.0 - a2_g) + a2_g,
                                          min=0.0))
        vis = 0.5 / torch.clamp(gv + gl, min=1e-8)
        p5 = _pow5(1.0 - voh)
        k_spec = torch.where(front, nol * d_ggx * vis * rw, 0.0)
        k_trans = nol * wt
        sum_r = k_diff * alr + k_spec * (f0r + (1.0 - f0r) * p5) \
            + k_trans * cr
        sum_g = k_diff * alg + k_spec * (f0g + (1.0 - f0g) * p5) \
            + k_trans * cg
        sum_b = k_diff * alb + k_spec * (f0b + (1.0 - f0b) * p5) \
            + k_trans * cb
        lum = (0.2126 * sum_r * em_r + 0.7152 * sum_g * em_g
               + 0.0722 * sum_b * em_b)
        p_hat = torch.where(valid & (lpow > 0), lum * inv_cone, 0.0)

        if n_b > 0:
            pdf_diff = torch.where(front, nol * INV_PI, 0.0)
            pdf_spec = torch.where(
                front, g1_v * d_ggx / torch.clamp(4.0 * nov, min=1e-6), 0.0)
            p_w = wd * pdf_diff + ws * pdf_spec + wt * nol
            p_other = p_w * inv_cone
            p_self = 1.0 / torch.clamp(w_cand, min=1e-20)
            wi = m_total * p_hat / torch.clamp(
                n_l * p_self + n_b * p_other, min=1e-20)
            wi = torch.where(w_cand > 0, wi, 0.0)
        else:
            wi = p_hat * w_cand

        w_sum = w_sum + wi
        take = (u_keep * w_sum) < wi
        res_idx = torch.where(take, cand.to(torch.int32), res_idx)
        res_aux = torch.where(take, laux.to(torch.int32), res_aux)
        res_uv0 = torch.where(take, uv0, res_uv0)
        res_uv1 = torch.where(take, uv1, res_uv1)
        res_phat = torch.where(take, p_hat, res_phat)
        win_dx = torch.where(take, ldx, win_dx)
        win_dy = torch.where(take, ldy, win_dy)
        win_dz = torch.where(take, ldz, win_dz)
        win_dist = torch.where(take, ldist, win_dist)

    out_f = torch.stack([res_uv0, res_uv1, res_phat, w_sum, win_dx, win_dy,
                         win_dz, win_dist])
    return out_f, torch.stack([res_idx, res_aux])


def _check(name, x, rows, n=None):
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != rows:
        raise ValueError(f"{name} must be ({rows}, N) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if n is not None and x.shape[1] != n:
        raise ValueError(f"{name} has {x.shape[1]} columns, expected {n}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def initial_light_candidates(surf, uni, slots, table, n_l: int, s: int,
                             n_b: int):
    """B3; see initial_light_candidates_plain for the contract. A CUDA
    tensor launches drts_initial_light_candidates (csrc/restir.cu)."""
    n = surf.shape[1]
    _check("surf", surf, N_SURF_ROWS)
    _check("uni", uni, 4 * n_l, n)
    _check("slots", slots, 2 * s, n)
    if (table.dtype != torch.float32 or table.dim() != 2
            or table.shape[1] != TABLE_COLS or not table.is_contiguous()
            or not 1 <= table.shape[0] <= MAX_TABLE_ROWS):
        raise ValueError(f"table must be contiguous (L, {TABLE_COLS}) "
                         f"float32 with 1 <= L <= {MAX_TABLE_ROWS}, got "
                         f"{tuple(table.shape)} {table.dtype}")
    devices = {x.device for x in (surf, uni, slots, table)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    if n_l < 1 or s < 1 or n_b < 0:
        raise ValueError(f"need n_l >= 1, s >= 1, n_b >= 0 "
                         f"(got {n_l}, {s}, {n_b})")
    if surf.device.type == "cpu":
        return initial_light_candidates_plain(surf, uni, slots, table, n_l,
                                              s, n_b)
    if surf.device.type != "cuda":
        raise ValueError(f"unsupported device {surf.device}")
    out_f = torch.empty((8, n), dtype=torch.float32, device=surf.device)
    out_i = torch.empty((2, n), dtype=torch.int32, device=surf.device)
    rc = backend.kernels().drts_initial_light_candidates(
        surf.data_ptr(), uni.data_ptr(), slots.data_ptr(), n,
        table.data_ptr(), table.shape[0], n_l, s, n_b, out_f.data_ptr(),
        out_i.data_ptr(), backend.stream_handle(surf))
    backend.check_launch(rc, "drts_initial_light_candidates")
    backend.launched("initial_light_candidates")
    return out_f, out_i


def initial_light_candidates_info(n_lights: int, s: int) -> dict:
    """B3's resources on the card for a light table of ``n_lights`` rows
    and ``s`` slots: registers and local (stack and spill) bytes per
    thread, shared bytes and threads per block, and the blocks one SM holds
    at once."""
    out = (ctypes.c_int * 5)()
    rc = backend.kernels().drts_initial_light_candidates_info(n_lights, s,
                                                              out)
    backend.check_launch(rc, "drts_initial_light_candidates_info")
    return dict(zip(("registers", "local_bytes", "shared_bytes", "threads",
                     "blocks_per_sm"), out))
