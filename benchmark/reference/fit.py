"""Plain PyTorch reference of SkelSplat's per-frame fit, written from the
upstream method and independent of the program under test.

One frame: N Gaussians, one per joint, start at the initial pose (log-scale
``scaling``, the extremity joints' times ``scaling_modifier``, identity
rotation, opacity 1). The GT heatmaps are made once, from the initial
covariance: per view and joint a 255-impulse at the detection, blurred by a
truncated (4σ), reflect-mode Gaussian filter whose two sigmas are the
square roots of the eigenvalues of the joint's projected, dilated
covariance, then min-max normalised over the view's image. Each iteration
renders one view round-robin: EWA projection, 3σ screen radius, 16×16 tile
rects, front-to-back α-compositing in depth order (α ≤ 0.99, skipped below
1/255, the pixel ends before T falls under 1e-4), channel j = Gaussian j's
α·T; the loss is the mean squared error over the pixels where the render
or the GT is non-zero, plus λ × the limb-length asymmetry of the 3D pose.
Every ``accumulation_steps`` iterations Adam steps once: the position
gradient is the mean of the views' gradients, the scale and rotation
gradients are the last view's, and the position learning rate decays
log-linearly, scaled by the rig's extent.

Here the ``accumulation_steps`` (= views) iterations between two Adam
steps run at the same parameters, so they are rendered together, per view
with its own copy of the parameters and one backward pass. Pixels are
rendered densely, every pixel of every 16×16 tile that some Gaussian's
rect covers or some channel's GT support meets: outside those tiles the
render and the GT are both 0, so no pixel there counts. Several frames run
together as a batch.

``precision="tf32"`` computes every matrix product with its operands
rounded to TF32's 10-bit mantissa, as tensor cores do when TF32 is on: the
control that the benchmark's limits are set against.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NEAR_Z = 0.2
H_VAR = 0.3          # EWA low-pass dilation, px²
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_MIN = 1.0e-4
TILE = 16
TRUNCATE = 4.0       # scipy.ndimage.gaussian_filter's default
AMPLITUDE = 255.0
NORM_EPS = 1e-8
ADAM_EPS = 1e-15


class _ClampST(torch.autograd.Function):
    """α = min(0.99, x), the gradient passed straight through: the
    upstream backward chains dL/dx = dL/dα with no clamp gate."""

    @staticmethod
    def forward(ctx, x):
        return torch.clamp(x, max=ALPHA_MAX)

    @staticmethod
    def backward(ctx, grad):
        return grad


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to 10 mantissa bits (to nearest, ties to even), with
    the gradient passed straight through."""
    i = x.detach().contiguous().view(torch.int32)
    r = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return x + (r.view(torch.float32) - x).detach()


class Reference:
    """The fit of one configuration on one device."""

    def __init__(self, config: dict, cams: dict, device="cpu",
                 precision: str = "float32"):
        if precision not in ("float32", "tf32"):
            raise ValueError(f"precision {precision!r}")
        if config["loss_function"] != "l2_gaussian":
            raise ValueError("the reference implements l2_gaussian only")
        if config["early_stopping"] != "no_stopping":
            raise ValueError("the reference implements no_stopping only")
        if config["accumulation_steps"] != config["views"]:
            raise ValueError("the reference renders every view once "
                             "between two Adam steps")
        self.cfg = config
        self.dev = torch.device(device)
        self.precision = precision

        def t(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype,
                                   device=self.dev)

        self.view4 = t(cams["view4"])              # (V,4,4)
        self.full4 = t(cams["full4"])
        self.fx, self.fy = t(cams["focal_x"]), t(cams["focal_y"])
        self.tanx, self.tany = t(cams["tan_fovx"]), t(cams["tan_fovy"])
        self.w = t(cams["width"]).to(torch.int64)  # (V,) true image sizes
        self.h = t(cams["height"]).to(torch.int64)
        centers = np.asarray(cams["cam_center"], np.float64)
        self.extent = float(np.linalg.norm(
            centers - centers.mean(axis=0), axis=1).max() * 1.1)
        self.W, self.H = config["width"], config["height"]

    # -- products and geometry ------------------------------------------------

    def _mm(self, a, b):
        if self.precision == "tf32":
            a, b = _tf32(a), _tf32(b)
        return a @ b

    def _homogeneous(self, xyz, M):
        """(…,N,3) points through (V,4,4) matrices → (…,V,N,4)."""
        ones = torch.ones(xyz.shape[:-1] + (1,), dtype=xyz.dtype,
                          device=xyz.device)
        p = torch.cat([xyz, ones], dim=-1)
        if p.dim() == 3:                           # (F,N,4): every view
            p = p[:, None]
        return self._mm(p, M.transpose(-1, -2))

    def covariance(self, log_scales, quats):
        """(…,N,3,3) world covariance R S Sᵀ Rᵀ."""
        q = quats / torch.linalg.vector_norm(quats, dim=-1, keepdim=True)
        w, x, y, z = q.unbind(-1)
        R = torch.stack([
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ], dim=-1).reshape(q.shape[:-1] + (3, 3))
        M = R * torch.exp(log_scales)[..., None, :]
        return self._mm(M, M.transpose(-1, -2))

    def _jacobian_frame(self, xyz):
        """View points with the 1.3·tan(fov/2) clamp, and the projective
        Jacobian (…,V,N,3,3), last row zero."""
        t = self._homogeneous(xyz, self.view4)[..., :3]
        tz = t[..., 2]
        limx = 1.3 * self.tanx[:, None]
        limy = 1.3 * self.tany[:, None]
        tx = torch.clamp(t[..., 0] / tz, -limx, limx) * tz
        ty = torch.clamp(t[..., 1] / tz, -limy, limy) * tz
        fx, fy = self.fx[:, None], self.fy[:, None]
        zero = torch.zeros_like(tz)
        J = torch.stack([fx / tz, zero, -fx * tx / (tz * tz),
                         zero, fy / tz, -fy * ty / (tz * tz),
                         zero, zero, zero], dim=-1)
        return t, J.reshape(tz.shape + (3, 3))

    def screen(self, xyz, cov):
        """Per view: pixel centre (F,V,N,2), depth, conic (a, b, c), 3σ
        radius and validity of (F,V,N,3) points with covariances
        (F,V,N,3,3), copy v seen by view v."""
        t, J = self._jacobian_frame(xyz)
        hom = self._homogeneous(xyz, self.full4)
        ndc = hom[..., :2] * (1.0 / (hom[..., 3:4] + 1e-7))
        size = torch.stack([self.w, self.h], -1).to(torch.float32)[:, None]
        pix = ((ndc + 1.0) * size - 1.0) * 0.5
        B = self._mm(J[..., :2, :], self.view4[:, None, :3, :3])
        cov2 = self._mm(self._mm(B, cov), B.transpose(-1, -2))
        a = cov2[..., 0, 0] + H_VAR
        b = cov2[..., 0, 1]
        c = cov2[..., 1, 1] + H_VAR
        det = a * c - b * b
        inv = torch.where(det != 0, 1.0 / det, torch.zeros_like(det))
        conic = torch.stack([c * inv, -b * inv, a * inv], dim=-1)
        mid = 0.5 * (a + c)
        disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
        radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(mid + disc,
                                                           mid - disc)))
        valid = (t[..., 2] > NEAR_Z) & (det != 0)
        return pix, t[..., 2], conic, radius, valid

    def tile_rects(self, pix, radius):
        """[x0, y0, x1, y1) in tiles, C's truncating division, clamped."""
        gx, gy = -(-self.W // TILE), -(-self.H // TILE)
        px, py = pix[..., 0], pix[..., 1]

        def div(v, hi):
            return torch.clamp(torch.trunc(v / TILE), 0, hi)

        return torch.stack([div(px - radius, gx), div(py - radius, gy),
                            div(px + radius + TILE - 1, gx),
                            div(py + radius + TILE - 1, gy)], dim=-1)

    # -- GT heatmaps ------------------------------------------------------------

    def _profiles(self, centre, sigma, size):
        """Reflect-mode truncated Gaussian filter of a unit impulse at
        ``centre`` along an axis of ``size`` (per view) pixels: (…,V,N,L)
        on the grid's L pixels, 0 beyond the view's size."""
        L = int(max(self.W, self.H))
        r = torch.floor(TRUNCATE * sigma + 0.5)
        R = int(r.max().item())
        d = torch.arange(-R, R + 1, dtype=torch.float32, device=self.dev)
        taps = torch.exp(-0.5 / (sigma[..., None] ** 2) * d * d)
        taps = torch.where(d.abs() <= r[..., None], taps,
                           torch.zeros_like(taps))
        taps = taps / taps.sum(-1, keepdim=True)
        n = size.reshape(size.shape + (1, 1, 1))   # (V,1,1,1)
        y = torch.arange(L, device=self.dev)
        i = y[:, None] + d.to(torch.int64)         # (L, 2R+1)
        src = torch.where(i < 0, -i - 1, torch.where(i >= n, 2 * n - 1 - i,
                                                     i))
        hit = src == centre[..., None, None]       # (…,V,N,L,2R+1)
        prof = (hit * taps[..., None, :]).sum(-1)
        return torch.where(y < n[..., 0], prof, torch.zeros_like(prof))

    def gt_sigmas(self, xyz0, cov0):
        """(F,V,N) blur sigmas of the GT, (rows, columns): the square roots
        of the eigenvalues of the dilated 2D covariance that the upstream
        heatmap code projects, (W·J)ᵀ Σ (W·J)."""
        t, J = self._jacobian_frame(xyz0)
        A = self._mm(self.view4[:, None, :3, :3], J)
        cov = self._mm(self._mm(A.transpose(-1, -2),
                                cov0[:, None].transpose(-1, -2)), A)
        a = cov[..., 0, 0] + H_VAR
        b = cov[..., 0, 1]
        c = cov[..., 1, 1] + H_VAR
        mid = 0.5 * (a + c)
        disc = torch.sqrt(torch.clamp(mid * mid - (a * c - b * b), min=0.1))
        return torch.sqrt(mid + disc), torch.sqrt(mid - disc)

    def detections(self, p2d):
        """(F,V,N) pixel of each detection's impulse, (x, y): truncated,
        then clamped into the view's image."""
        w = self.w[:, None].to(torch.float32)
        h = self.h[:, None].to(torch.float32)
        x0 = torch.minimum(torch.clamp(torch.trunc(p2d[..., 0]), min=0),
                           w - 1).to(torch.int64)
        y0 = torch.minimum(torch.clamp(torch.trunc(p2d[..., 1]), min=0),
                           h - 1).to(torch.int64)
        return x0, y0

    def heatmaps(self, xyz0, cov0, p2d):
        """The GT as (row profile (F,V,N,H), column profile (F,V,N,W), min,
        max) of each channel's 255·row⊗column image over the view's image,
        and each channel's support (F,V,N,4) = [x0, y0, x1, y1), the box
        outside which its GT is 0."""
        s_rows, s_cols = self.gt_sigmas(xyz0, cov0)
        x0, y0 = self.detections(p2d)
        rows = self._profiles(y0, s_rows, self.h)[..., :self.H]
        cols = self._profiles(x0, s_cols, self.w)[..., :self.W]
        F, V, N = rows.shape[:3]
        mn = torch.empty((F, V, N), device=self.dev)
        mx = torch.empty((F, V, N), device=self.dev)
        for f in range(F):
            for v in range(V):
                hv, wv = int(self.h[v]), int(self.w[v])
                img = AMPLITUDE * (rows[f, v, :, :hv, None]
                                   * cols[f, v, :, None, :wv])
                mn[f, v] = img.amin(dim=(1, 2))
                mx[f, v] = img.amax(dim=(1, 2))

        def span(prof):                 # first, one past last non-zero
            nz = prof > 0
            L = prof.shape[-1]
            first = torch.argmax(nz.to(torch.uint8), dim=-1)
            last = L - torch.argmax(nz.flip(-1).to(torch.uint8), dim=-1)
            has = nz.any(dim=-1)
            return (torch.where(has, first, 0), torch.where(has, last, 0))

        (ry0, ry1), (cx0, cx1) = span(rows), span(cols)
        support = torch.stack([cx0, ry0, cx1, ry1], dim=-1)
        return rows, cols, mn, mx, support

    # -- one macro step ---------------------------------------------------------

    def _tiles(self, rect, valid, support):
        """The pixels to render, per view: every pixel of every 16×16 tile
        that a valid Gaussian's rect covers or a channel's GT support
        meets (outside them the render and the GT are both 0). Returns
        (ys, xs) (F,V,P) pixel rows and columns, ``tile`` (F,V,P,2) each
        pixel's tile (x, y), and ``inside`` (F,V,P): the pixel is real and
        in the view's image."""
        F, V = valid.shape[:2]
        gx, gy = -(-self.W // TILE), -(-self.H // TILE)
        tx = torch.arange(gx, device=self.dev)
        ty = torch.arange(gy, device=self.dev)[:, None]
        r = rect.to(torch.int64)[..., None, None, :]
        by_rect = (valid[..., None, None] & (tx >= r[..., 0]) & (tx < r[..., 2])
                   & (ty >= r[..., 1]) & (ty < r[..., 3]))
        g = support[..., None, None, :]
        by_gt = ((tx * TILE < g[..., 2]) & ((tx + 1) * TILE > g[..., 0])
                 & (ty * TILE < g[..., 3]) & ((ty + 1) * TILE > g[..., 1]))
        active = (by_rect | by_gt).any(dim=2).reshape(F, V, gx * gy)
        count = active.sum(-1)
        K = max(int(count.max()), 1)
        order = torch.argsort((~active).to(torch.uint8), dim=-1,
                              stable=True)[..., :K]
        real = torch.arange(K, device=self.dev) < count[..., None]
        t_x, t_y = order % gx, order // gx                 # (F,V,K)
        d = torch.arange(TILE, device=self.dev)
        ys = (t_y * TILE)[..., None, None] + d[:, None]    # (F,V,K,16,16)
        xs = (t_x * TILE)[..., None, None] + d[None, :]
        shape = (F, V, K * TILE * TILE)
        full = (F, V, K, TILE, TILE)
        ys = ys.expand(full).reshape(shape)
        xs = xs.expand(full).reshape(shape)
        tile = torch.stack([t_x, t_y], -1)[..., None, :].expand(
            F, V, K, TILE * TILE, 2).reshape(shape + (2,))
        inside = (real[..., None].expand(F, V, K, TILE * TILE).reshape(shape)
                  & (ys < self.h[:, None]) & (xs < self.w[:, None]))
        return ys, xs, tile, inside

    def _views_loss(self, xyz, log_scales, quats, gt):
        """(S, C) (F,V) of each view at its own parameter copy (F,V,N,·):
        the sum of squared errors over the masked pixels, and their
        count."""
        rows, cols, mn, mx, support = gt
        F, V, N, _ = xyz.shape
        cov = self.covariance(log_scales, quats)          # (F,V,N,3,3)
        pix, depth, conic, radius, valid = self.screen(xyz, cov)
        rect = self.tile_rects(pix, radius).detach()
        area = (rect[..., 2] - rect[..., 0]) * (rect[..., 3] - rect[..., 1])
        valid = valid & (area > 0)
        with torch.no_grad():
            ys, xs, tile, inside = self._tiles(rect, valid, support)
        # where a padded pixel lies off the grid, read the last one (masked)
        ys_at = torch.clamp(ys, max=self.H - 1)
        xs_at = torch.clamp(xs, max=self.W - 1)
        xf, yf = xs.to(torch.float32), ys.to(torch.float32)
        # slots in depth order; the invalid ones last
        key = torch.where(valid, depth.detach(),
                          torch.full_like(depth, float("inf")))
        order = torch.argsort(key, dim=-1, stable=True)        # (F,V,N)
        T = torch.ones(xf.shape, device=self.dev)
        done = torch.zeros(xf.shape, dtype=torch.bool, device=self.dev)
        S = torch.zeros((F, V), device=self.dev)
        C = torch.zeros((F, V), dtype=torch.int64, device=self.dev)

        def slot(x, j):     # Gaussian j (F,V) of every view
            return torch.gather(x, 2, j.reshape(F, V, 1, *([1] * (x.dim() - 3)))
                                .expand(F, V, 1, *x.shape[3:])).squeeze(2)

        for i in range(N):
            j = order[..., i]
            p, cn = slot(pix, j), slot(conic, j)
            r4, ok = slot(rect, j), slot(valid, j)
            dx = p[..., 0, None] - xf
            dy = p[..., 1, None] - yf
            power = (-0.5 * (cn[..., 0, None] * dx * dx
                             + cn[..., 2, None] * dy * dy)
                     - cn[..., 1, None] * dx * dy)
            alpha = _ClampST.apply(torch.exp(power))      # opacity 1
            in_rect = ((tile[..., 0] >= r4[..., 0, None])
                       & (tile[..., 0] < r4[..., 2, None])
                       & (tile[..., 1] >= r4[..., 1, None])
                       & (tile[..., 1] < r4[..., 3, None]))
            gate = (ok[..., None] & (power <= 0) & (alpha >= ALPHA_MIN)
                    & in_rect & ~done)
            test = T * (1.0 - alpha)
            stop = gate & (test < T_MIN)
            live = gate & ~stop
            render = torch.clamp(torch.where(live, alpha * T,
                                             torch.zeros_like(T)), 0.0, 1.0)
            T = torch.where(live, test, T)
            done = done | stop
            r_p = torch.gather(slot(rows, j), 2, ys_at)
            c_p = torch.gather(slot(cols, j), 2, xs_at)
            lo = slot(mn, j)[..., None]
            hi = slot(mx, j)[..., None]
            raw = AMPLITUDE * (r_p * c_p)
            gt_px = torch.where(inside, (raw - lo) / (hi - lo + NORM_EPS),
                                torch.zeros_like(raw))
            mask = ((gt_px > 0) | (render > 0)) & inside
            err = (render - gt_px) ** 2
            S = S + torch.where(mask, err, torch.zeros_like(err)).sum(-1)
            C = C + mask.sum(-1)
        return S, C

    def limb_asymmetry(self, xyz):
        """|‖l_arm‖ − ‖r_arm‖| + |‖l_leg‖ − ‖r_leg‖| of (…,N,3) joints."""
        (a0, a1), (b0, b1), (c0, c1), (d0, d1) = self.cfg["limb_pairs"]

        def limb(i, j):
            return torch.linalg.vector_norm(xyz[..., i, :] - xyz[..., j, :],
                                            dim=-1)

        return (torch.abs(limb(a0, a1) - limb(b0, b1))
                + torch.abs(limb(c0, c1) - limb(d0, d1)))

    def position_lr(self, iteration: int) -> float:
        c = self.cfg
        t = min(max(iteration / c["position_lr_max_steps"], 0.0), 1.0)
        return self.extent * math.exp(math.log(c["position_lr_init"]) * (1 - t)
                                      + math.log(c["position_lr_final"]) * t)

    # -- the fit ----------------------------------------------------------------

    def fit(self, init, p2d, iterations: int | None = None):
        """Fit F frames: ``init`` (F,N,3), ``p2d`` (F,V,N,2). Returns (xyz
        (F,N,3), the last step's per-view losses (F,V)) as numpy."""
        cfg = self.cfg
        dev = self.dev
        xyz = torch.as_tensor(np.asarray(init, np.float32), device=dev).clone()
        p2d = torch.as_tensor(np.asarray(p2d, np.float32), device=dev)
        F, N, _ = xyz.shape
        V = cfg["views"]
        log_s = np.full((N, 3), cfg["scaling"], np.float32)
        boosted = np.float32(cfg["scaling"]) * np.float32(
            cfg["scaling_modifier"])
        log_s[[j for j in cfg["extremity_joints"] if j < N]] = boosted
        log_scales = torch.as_tensor(log_s, device=dev).expand(F, N, 3).clone()
        quats = torch.zeros((F, N, 4), device=dev)
        quats[..., 0] = 1.0
        with torch.no_grad():
            gt = self.heatmaps(xyz, self.covariance(log_scales, quats), p2d)
        params = [xyz.requires_grad_(), log_scales.requires_grad_(),
                  quats.requires_grad_()]
        opt = torch.optim.Adam(
            [{"params": [xyz], "lr": 0.0},
             {"params": [log_scales], "lr": cfg["scaling_lr"]},
             {"params": [quats], "lr": cfg["rotation_lr"]}],
            betas=(0.9, 0.999), eps=ADAM_EPS, foreach=False)
        A = cfg["accumulation_steps"]
        lam = cfg["lambda_consistency"]
        losses = None
        for k in range((iterations or cfg["iterations"]) // A):
            copies = [p.detach()[:, None].expand(F, V, *p.shape[1:]).clone()
                      .requires_grad_() for p in params]
            with torch.enable_grad():
                S, C = self._views_loss(*copies, gt)
                gx, gs, gq = torch.autograd.grad(S.sum(), copies)
                xyz_l = params[0].detach().clone().requires_grad_()
                cons = self.limb_asymmetry(xyz_l)
                (gc,) = torch.autograd.grad(cons.sum(), [xyz_l])
            n = torch.clamp(C, min=1).to(torch.float32)
            losses = S.detach() / n + lam * cons.detach()[:, None]
            scale = (1.0 / n)[..., None, None]
            xyz.grad = (gx * scale).mean(dim=1) + lam * gc
            log_scales.grad = gs[:, -1] * scale[:, -1]
            quats.grad = gq[:, -1] * scale[:, -1]
            opt.param_groups[0]["lr"] = self.position_lr(k * A + A)
            opt.step()
        return (xyz.detach().cpu().numpy(),
                None if losses is None else losses.cpu().numpy())
