"""Independent NumPy *recursive* path tracer used as a statistical oracle.

Re-implements the reference's estimator (`ray_color`,
/root/reference/src/ray.rs:78-127) in its original recursive per-ray form
— deliberately a SECOND implementation, sharing no code with the
wavefront integrator — so tests can check that the iterative wavefront
formulation computes the same light transport (SURVEY.md §7 "recursion ->
iteration fidelity"). Reads primitives from a compiled SceneData (numpy
views), samples with an independent numpy Generator.

Supports: triangles, spheres (static), quads, constant media with a
sphere boundary (Isotropic phase), Lambertian (with the 50/50
light-mixture importance sampling), Metal, Dielectric, DiffuseLight,
solid / checker / marble-noise textures, background. No image textures or
motion blur (keep oracle scenes simple).
"""

from __future__ import annotations

import numpy as np

T_MIN = 1e-4
PDF_FLOOR = 1e-5


def _norm(v):
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


class Oracle:
    def __init__(self, sd):
        g = lambda x: np.asarray(x)  # noqa: E731
        self.tri_v0, self.tri_e1, self.tri_e2 = map(
            g, (sd.tri_v0, sd.tri_e1, sd.tri_e2))
        self.tri_mat = g(sd.tri_mat)
        self.tri_double = g(sd.tri_double)
        # drop the zero-edge pad triangles (they can never hit)
        real = (np.abs(self.tri_e1).sum(1) + np.abs(self.tri_e2).sum(1)) > 0
        self.tri_v0, self.tri_e1, self.tri_e2, self.tri_mat, \
            self.tri_double = (x[real] for x in (
                self.tri_v0, self.tri_e1, self.tri_e2, self.tri_mat,
                self.tri_double))
        self.sph_c = g(sd.sph_c0)
        self.sph_r = g(sd.sph_r)
        self.sph_mat = g(sd.sph_mat)
        self.quad_q, self.quad_u, self.quad_v = map(
            g, (sd.quad_q, sd.quad_u, sd.quad_v))
        self.quad_mat = g(sd.quad_mat)
        self.quad_flip = g(sd.quad_flip)
        self.mat_kind = g(sd.mat_kind)
        self.mat_tex = g(sd.mat_tex)
        self.mat_fuzz = g(sd.mat_fuzz)
        self.mat_ior = g(sd.mat_ior)
        self.tex_color = g(sd.tex_color)
        self.tex_kind = g(sd.tex_kind)
        self.tex_scale = g(sd.tex_scale)
        self.tex_even = g(sd.tex_even)
        self.tex_odd = g(sd.tex_odd)
        self.perlin = tuple(map(g, (sd.perlin_vec, sd.perlin_px,
                                    sd.perlin_py, sd.perlin_pz)))
        self.med_c = g(sd.med_c)
        self.med_r = g(sd.med_r)
        self.med_neg_inv_d = g(sd.med_neg_inv_d)
        self.med_mat = g(sd.med_mat)
        self.med_kind = g(sd.med_kind)
        self.light_kind = g(sd.light_kind)
        self.light_c = g(sd.light_c)
        self.light_r = g(sd.light_r)
        self.light_q = g(sd.light_q)
        self.light_u = g(sd.light_u)
        self.light_v = g(sd.light_v)
        self.background = g(sd.background)

    # ---- intersection (closest hit over all primitives) ----------------
    def hit(self, o, d, t_min=T_MIN, t_max=np.inf):
        best = None  # (t, point, normal, mat, flip)
        # triangles (Möller–Trumbore, triangle.rs:38-69)
        for i in range(len(self.tri_v0)):
            v0, e1, e2 = self.tri_v0[i], self.tri_e1[i], self.tri_e2[i]
            p = np.cross(d, e2)
            det = e1 @ p
            # scale-invariant grazing cutoff (matches _tri_coeffs'
            # unit-normal scaling: |det| > EPS·|d|·|n|); the reference's
            # absolute 1e-5 rejects every triangle of a millimetre mesh
            eps = 1e-5 * np.linalg.norm(d) * np.linalg.norm(
                np.cross(e1, e2))
            if det < eps and not (self.tri_double[i] and det < -eps):
                continue
            if abs(det) < eps or eps == 0.0:
                continue
            tv = o - v0
            u = (tv @ p) / det
            if u < 0 or u > 1:
                continue
            q = np.cross(tv, e1)
            v = (d @ q) / det
            if v < 0 or v >= 1 - u:
                continue
            t = (e2 @ q) / det
            if t < t_min or t > t_max:
                continue
            if best is None or t < best[0]:
                n = _norm(np.cross(e1, e2)) * np.sign(det)
                best = (t, o + t * d, n, self.tri_mat[i], False)
        # spheres (sphere.rs:52-95)
        for i in range(len(self.sph_c)):
            if self.sph_r[i] <= 0:
                continue
            oc = o - self.sph_c[i]
            a = d @ d
            b = oc @ d
            cc = oc @ oc - self.sph_r[i] ** 2
            disc = b * b - a * cc
            if disc <= 0:
                continue
            sq = np.sqrt(disc)
            for root in ((-b - sq) / a, (-b + sq) / a):
                if t_min <= root <= t_max:
                    t = root
                    if best is None or t < best[0]:
                        p = o + t * d
                        n = (p - self.sph_c[i]) / self.sph_r[i]
                        best = (t, p, n, self.sph_mat[i], False)
                    break
        # quads (aarect lowered; both sides, normal faces ray)
        for i in range(len(self.quad_q)):
            u_e, v_e = self.quad_u[i], self.quad_v[i]
            n = np.cross(u_e, v_e)
            denom = d @ n
            if denom == 0:
                continue
            t = ((self.quad_q[i] - o) @ n) / denom
            if t < t_min or t > t_max or not np.isfinite(t):
                continue
            w = o + t * d - self.quad_q[i]
            n2 = n @ n
            if n2 == 0:
                continue
            alpha = (np.cross(w, v_e) @ n) / n2
            beta = (np.cross(u_e, w) @ n) / n2
            if not (0 <= alpha <= 1 and 0 <= beta <= 1):
                continue
            if best is None or t < best[0]:
                nh = _norm(n)
                nh = nh * -np.sign(d @ nh)
                if self.quad_flip[i]:
                    nh = np.array([nh[0], -abs(nh[1]), nh[2]])
                best = (t, o + t * d, nh, self.quad_mat[i], False)
        return best

    def medium_hit(self, o, d, rng, t_min=T_MIN):
        """Closest constant-medium scatter (constant_medium.rs:46-80):
        boundary roots over (-inf, inf), clamp to t_min, exponential free
        flight. Returns (t, mat) or None. Sphere boundaries only."""
        best = None
        for i in range(len(self.med_c)):
            if self.med_kind[i] != 0:
                raise NotImplementedError("oracle media: spheres only")
            oc = o - self.med_c[i]
            a = d @ d
            b = oc @ d
            cc = oc @ oc - self.med_r[i] ** 2
            disc = b * b - a * cc
            u = rng.random()
            if disc <= 0:
                continue
            sq = np.sqrt(disc)
            t1 = max((-b - sq) / a, t_min)
            t2 = (-b + sq) / a
            if t1 >= t2:
                continue
            t1 = max(t1, 0.0)
            ray_len = np.sqrt(a)
            hit_dist = self.med_neg_inv_d[i] * np.log(max(u, 1e-30))
            if hit_dist > (t2 - t1) * ray_len:
                continue
            t = t1 + hit_dist / ray_len
            if best is None or t < best[0]:
                best = (t, self.med_mat[i])
        return best

    # ---- textures (texture.rs) ------------------------------------------
    def _noise(self, p):
        vec, px, py, pz = self.perlin
        pf = np.floor(p)
        u, v, w = p - pf
        i, j, k = (int(x) for x in pf)
        uu, vv, ww = (x * x * (3 - 2 * x) for x in (u, v, w))
        acc = 0.0
        for di in range(2):
            for dj in range(2):
                for dk in range(2):
                    h = (px[(i + di) & 255] ^ py[(j + dj) & 255]
                         ^ pz[(k + dk) & 255])
                    acc += ((di * uu + (1 - di) * (1 - uu))
                            * (dj * vv + (1 - dj) * (1 - vv))
                            * (dk * ww + (1 - dk) * (1 - ww))
                            * (vec[h] @ np.array([u - di, v - dj, w - dk])))
        return acc

    def texture(self, tid, p):
        kind = self.tex_kind[tid]
        if kind == 1:       # checker (texture.rs:50-57)
            sines = np.sin(10 * p[0]) * np.sin(10 * p[1]) * np.sin(10 * p[2])
            return self.texture(
                self.tex_odd[tid] if sines < 0 else self.tex_even[tid], p)
        if kind == 2:       # marble (texture.rs:74-82, perlin.rs:58-71)
            acc, wgt, tp = 0.0, 1.0, p.copy()
            for _ in range(7):
                acc += wgt * self._noise(tp)
                wgt *= 0.5
                tp = tp * 2
            return np.full(3, 0.5 * (1 + np.sin(self.tex_scale[tid] * p[2]
                                                + 10 * abs(acc))))
        if kind == 3:
            raise NotImplementedError("oracle: no image textures")
        return self.tex_color[tid]

    # ---- light sampling (pdf.rs + sphere.rs:101-119, aarect.rs:123-143)
    def lights_pdf(self, origin, direction):
        vals = []
        for i in range(len(self.light_kind)):
            k = self.light_kind[i]
            if k == 0:      # sphere
                oc = origin - self.light_c[i]
                a = direction @ direction
                b = oc @ direction
                cc = oc @ oc - self.light_r[i] ** 2
                disc = b * b - a * cc
                hits = disc > 0 and (
                    (-b - np.sqrt(disc)) / a >= 1e-4
                    or (-b + np.sqrt(disc)) / a >= 1e-4)
                if hits:
                    dist_sq = ((self.light_c[i] - origin) ** 2).sum()
                    cos_max = np.sqrt(
                        max(1 - self.light_r[i] ** 2 / dist_sq, 0))
                    vals.append(1.0 / (2 * np.pi * (1 - cos_max)))
                else:
                    vals.append(0.0)
            elif k == 1:    # quad
                n = np.cross(self.light_u[i], self.light_v[i])
                denom = direction @ n
                if denom == 0:
                    vals.append(0.0)
                    continue
                t = ((self.light_q[i] - origin) @ n) / denom
                w = origin + t * direction - self.light_q[i]
                n2 = n @ n
                alpha = (np.cross(w, self.light_v[i]) @ n) / n2
                beta = (np.cross(self.light_u[i], w) @ n) / n2
                if t >= 1e-3 and 0 <= alpha <= 1 and 0 <= beta <= 1:
                    area = np.sqrt(n2)
                    dist_sq = t * t * (direction @ direction)
                    cos = abs(direction @ n / np.sqrt(n2)) / np.sqrt(
                        direction @ direction)
                    vals.append(dist_sq / (cos * area))
                else:
                    vals.append(0.0)
            else:
                vals.append(0.0)
        return float(np.mean(vals))

    def lights_sample(self, origin, rng):
        i = rng.integers(0, len(self.light_kind))
        k = self.light_kind[i]
        if k == 0:
            to_c = self.light_c[i] - origin
            dist_sq = to_c @ to_c
            cos_max = np.sqrt(max(1 - self.light_r[i] ** 2 / dist_sq, 0))
            u1, u2 = rng.random(), rng.random()
            z = 1 + u2 * (cos_max - 1)
            phi = 2 * np.pi * u1
            s = np.sqrt(max(1 - z * z, 0))
            local = np.array([np.cos(phi) * s, np.sin(phi) * s, z])
            w = _norm(to_c)
            a = (np.array([0, 1, 0.0])
                 if abs(w[0]) > 0.9 else np.array([1, 0, 0.0]))
            v = _norm(np.cross(w, a))
            u = np.cross(w, v)
            return local[0] * u + local[1] * v + local[2] * w
        if k == 1:
            pt = (self.light_q[i] + rng.random() * self.light_u[i]
                  + rng.random() * self.light_v[i])
            return pt - origin
        return np.array([1.0, 0.0, 0.0])

    # ---- the recursive estimator (ray.rs:78-127) -----------------------
    def ray_color(self, o, d, depth, rng):
        if depth <= 0:
            return np.zeros(3)
        rec = self.hit(o, d)
        if len(self.med_c):
            med = self.medium_hit(o, d, rng)
            if med is not None and (rec is None or med[0] < rec[0]):
                # Isotropic (material/mod.rs:196-216): specular scatter
                # into a uniform-ball direction, attenuation = albedo
                p = o + med[0] * d
                while True:
                    v = rng.random(3) * 2 - 1
                    if v @ v < 1:
                        break
                albedo = self.texture(self.mat_tex[med[1]], p)
                return albedo * self.ray_color(p, v, depth - 1, rng)
        if rec is None:
            return self.background.copy()
        t, p, n, mat, _ = rec
        kind = self.mat_kind[mat]
        color = self.texture(self.mat_tex[mat], p)
        unit_d = _norm(d)

        if kind == 3:   # DiffuseLight: emit iff front face, path ends
            return color.copy() if d @ n < 0 else np.zeros(3)

        if kind == 1:   # Metal
            refl = unit_d - 2 * (unit_d @ n) * n
            fuzz = self.mat_fuzz[mat]
            if fuzz > 0:
                while True:
                    v = rng.random(3) * 2 - 1
                    if v @ v < 1:
                        break
                refl = refl + fuzz * v
            if refl @ n <= 0:
                return np.zeros(3)
            return color * self.ray_color(p, refl, depth - 1, rng)

        if kind == 2:   # Dielectric
            ior = self.mat_ior[mat]
            exiting = d @ n > 0
            ratio = ior if exiting else 1.0 / ior
            n_or = -n if exiting else n
            cos_t = min(-(unit_d @ n_or), 1.0)
            sin_t = np.sqrt(max(1 - cos_t * cos_t, 0))
            r0 = ((1 - ior) / (1 + ior)) ** 2
            schlick = r0 + (1 - r0) * (1 - cos_t) ** 5
            if ratio * sin_t > 1.0 or schlick >= rng.random():
                nd = unit_d - 2 * (unit_d @ n) * n
            else:
                perp = ratio * (unit_d + cos_t * n_or)
                nd = perp - np.sqrt(abs(1 - perp @ perp)) * n_or
            return self.ray_color(p, nd, depth - 1, rng)

        # Lambertian: 50/50 mixture of cosine pdf and light pdf
        def cosine_dir():
            u1, u2 = rng.random(), rng.random()
            z = np.sqrt(1 - u2)
            phi = 2 * np.pi * u1
            sr = np.sqrt(u2)
            local = np.array([np.cos(phi) * sr, np.sin(phi) * sr, z])
            w = _norm(n)
            a = (np.array([0, 1, 0.0])
                 if abs(w[0]) > 0.9 else np.array([1, 0, 0.0]))
            v = _norm(np.cross(w, a))
            u = np.cross(w, v)
            return local[0] * u + local[1] * v + local[2] * w

        have_lights = len(self.light_kind) > 0
        if have_lights and rng.random() < 0.5:
            nd = self.lights_sample(p, rng)
        else:
            nd = cosine_dir()
        cos_pdf = max(_norm(nd) @ n, 0) / np.pi
        pdf = (0.5 * cos_pdf + 0.5 * self.lights_pdf(p, nd)) \
            if have_lights else cos_pdf
        pdf = max(pdf, PDF_FLOOR)
        spdf = max(_norm(nd) @ n / np.pi, 0)
        return color * spdf / pdf * self.ray_color(p, nd, depth - 1, rng)


def render_oracle(sd, cam_scale, cam_aspect, c2w, width, height, spp,
                  depth, seed=0):
    """Mean image [H,W,3] via the recursive oracle (slow; keep tiny)."""
    rng = np.random.default_rng(seed)
    orc = Oracle(sd)
    img = np.zeros((height, width, 3))
    origin = c2w[:, 3]
    for y in range(height):
        for x in range(width):
            acc = np.zeros(3)
            for _ in range(spp):
                px = (2 * (x + rng.random() + 0.5) / width - 1) \
                    * cam_scale * cam_aspect
                py = (2 * (y + rng.random() + 0.5) / height - 1) * cam_scale
                point = c2w[:, :3] @ np.array([px, py, -1.0]) + c2w[:, 3]
                acc += np.nan_to_num(
                    orc.ray_color(origin, point - origin, depth, rng),
                    nan=0.0, posinf=0.0)
            img[y, x] = acc / spp
    return img
