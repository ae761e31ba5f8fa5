"""Z-buffer rasterization by bounding boxes, plain float32.

A pixel (x, y) is sampled at its centre (x + 0.5, y + 0.5). A triangle
covers it when its three barycentrics (edge functions over the signed
area, either winding) are all >= 0; a triangle of |area| <= 1e-12 px^2
covers nothing. Depth is the camera depth interpolated linearly in
screen space; the nearest triangle wins, and on equal depth the lowest
face id. Each triangle tests only the pixel centres inside its
bounding box, which is every test the function needs."""

from __future__ import annotations

import torch


def box_centres(lo, hi, size: int):
    """First pixel index and count of the centres p + 0.5 in [lo, hi]."""
    first = torch.clamp(torch.ceil(lo - 0.5), min=0)
    last = torch.clamp(torch.floor(hi - 0.5), max=size - 1)
    n = torch.clamp(last - first + 1, min=0)
    return first.to(torch.int64), torch.nan_to_num(n, 0.0).to(torch.int64)


def barycentrics(p0, p1, p2, qx, qy):
    """Edge functions over the signed area; (w0, w1, w2, area)."""
    area = ((p1[..., 0] - p0[..., 0]) * (p2[..., 1] - p0[..., 1])
            - (p1[..., 1] - p0[..., 1]) * (p2[..., 0] - p0[..., 0]))
    safe = torch.where(area.abs() <= 1e-12, torch.ones_like(area), area)

    def edge(a, b):
        return ((b[..., 0] - a[..., 0]) * (qy - a[..., 1])
                - (b[..., 1] - a[..., 1]) * (qx - a[..., 0]))
    return edge(p1, p2) / safe, edge(p2, p0) / safe, edge(p0, p1) / safe, area


def winners(screen, depth, faces, height: int, width: int,
            max_pairs: int = 1 << 24):
    """screen (B, N, 2), depth (B, N), faces (F, 3) -> tri_id (B, H, W)
    int64, -1 where no triangle covers the pixel."""
    bsz = screen.shape[0]
    out = torch.full((bsz, height * width), -1, dtype=torch.int64,
                     device=screen.device)
    for b in range(bsz):
        out[b] = _winners_one(screen[b], depth[b], faces, height, width,
                              max_pairs)
    return out.reshape(bsz, height, width)


def covering_pairs(screen, depth, faces, height: int, width: int,
                   max_pairs: int = 1 << 24):
    """Yields, in blocks of about max_pairs tests, the (pixel, depth,
    face) of every pixel centre that a triangle covers (one image)."""
    dev = screen.device
    p = screen[faces]                                   # (F, 3, 2)
    z = depth[faces]                                    # (F, 3)
    fx, nx = box_centres(p[..., 0].amin(1), p[..., 0].amax(1), width)
    fy, ny = box_centres(p[..., 1].amin(1), p[..., 1].amax(1), height)
    count = nx * ny
    ids = torch.nonzero(count > 0).squeeze(1)
    if ids.numel() == 0:
        return
    csum = torch.cumsum(count[ids], 0)
    start = 0
    while start < ids.numel():
        base = int(csum[start - 1]) if start else 0
        stop = max(int(torch.searchsorted(csum, base + max_pairs,
                                          right=True)), start + 1)
        sel = ids[start:stop]
        c = count[sel]
        f = torch.repeat_interleave(sel, c)
        local = (torch.arange(int(c.sum()), device=dev)
                 - torch.repeat_interleave(torch.cumsum(c, 0) - c, c))
        ix = fx[f] + local % nx[f]
        iy = fy[f] + local // nx[f]
        pf = p[f]
        w0, w1, w2, area = barycentrics(pf[:, 0], pf[:, 1], pf[:, 2],
                                        ix.to(torch.float32) + 0.5,
                                        iy.to(torch.float32) + 0.5)
        cov = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (area.abs() > 1e-12)
        zf = z[f]
        zz = w0 * zf[:, 0] + w1 * zf[:, 1] + w2 * zf[:, 2]
        yield (iy * width + ix)[cov], zz[cov], f[cov]
        start = stop


def _winners_one(screen, depth, faces, height, width, max_pairs):
    dev = screen.device
    best_z = torch.full((height * width,), float("inf"), device=dev)
    blocks = list(covering_pairs(screen, depth, faces, height, width,
                                 max_pairs))
    for pix, zz, _ in blocks:
        best_z.scatter_reduce_(0, pix, zz, "amin")
    big = torch.iinfo(torch.int64).max
    best_id = torch.full((height * width,), big, dtype=torch.int64,
                         device=dev)
    for pix, zz, f in blocks:
        at = zz == best_z[pix]
        best_id.scatter_reduce_(0, pix[at], f[at], "amin")
    return torch.where(best_id == big, -1, best_id)


def shade(tri_id, faces, screen, attrs):
    """The winner's barycentrics at each pixel centre and per-vertex
    attributes interpolated by them, differentiable in screen and attrs
    (tri_id carries no gradient, and depth none).

    tri_id (B, H, W), faces (F, 3), screen (B, N, 2), attrs: a tuple of
    (B, N, C) tensors. Returns (bary (B, H, W, 3), [(B, H, W, C)]), zero
    where tri_id < 0."""
    b, h, w = tri_id.shape
    hit = (tri_id >= 0).reshape(b, -1, 1)
    vid = faces[tri_id.clamp(min=0).reshape(b, -1)].reshape(b, -1)

    def corners(a):                                    # (B, P, 3, C)
        return a.gather(1, vid[..., None].expand(-1, -1, a.shape[-1])
                        ).reshape(b, h * w, 3, a.shape[-1])

    dev = screen.device
    qx = (torch.arange(w, device=dev, dtype=torch.float32) + 0.5).repeat(h)
    qy = (torch.arange(h, device=dev, dtype=torch.float32)
          + 0.5).repeat_interleave(w)
    p = corners(screen)
    w0, w1, w2, _ = barycentrics(p[:, :, 0], p[:, :, 1], p[:, :, 2], qx, qy)
    bary = torch.stack([w0, w1, w2], dim=-1) * hit
    out = [(corners(a) * bary[..., None]).sum(2) * hit for a in attrs]
    return (bary.reshape(b, h, w, 3),
            [o.reshape(b, h, w, o.shape[-1]) for o in out])
