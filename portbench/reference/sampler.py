'''
The guided query sampler of the reference: per frame, solid query/target
pairs drawn from the ground-truth cloud under a bias mixture, and free-space
pairs from candidate pools rejected by 1-NN distance to the target.

A frozen copy of occlusions4d_torch/sampler/guided.py over the plain
operators of reference/ops.py. Its draws come from one torch.Generator in a
fixed order, so with the program's generator seed and device it draws the
program's queries.
'''

import dataclasses

import torch

from .ops import (blind_sample_bounds, carla_output_bounds, cuboid_mask, masked_choice,
                  nn1_bidirectional, nn1_min_dist, sample_blind_random,
                  sample_uniform_3ball, valid_first_order)

# Column layout of target point clouds.
_COLS = {
    'greater': dict(inst=3, segm=3, view=4, E=9),
    'carla': dict(inst=4, segm=5, view=6, E=11),
}
_MAX_SEM_CLASSES = 32


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    min_z: float = -1.0
    cube_bounds: float = 10.0
    point_occupancy_radius: float = 0.25
    num_solid: int = 1024
    num_air: int = 1024
    predict_segmentation: bool = False
    semantic_classes: int = 13
    predict_tracking: bool = False
    data_kind: str = 'greater'
    point_sample_bias: str = 'none'
    cube_mode: int = 4
    low_prefer_min_z: float = 0.0
    low_prefer_max_z: float = 2.0

    @property
    def has(self):
        return lambda token: token in self.point_sample_bias


def _ramp_share(count, max_share):
    '''Full share at >= 256 candidates, linear ramp from 16, else 0.'''
    count = count.to(torch.float32)
    return torch.where(count >= 256, torch.full_like(count, max_share),
                       torch.where(count >= 16, count * max_share / 256.0,
                                   torch.zeros_like(count)))


def _rows(x, idx):
    '''x (B, N, C), idx (B, n) -> (B, n, C).'''
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _block_slots(boundaries, n_out):
    '''Category and in-block offset of every output slot, given the (B, C-1)
    cumulative block ends (the last block is implicit).'''
    B = boundaries.shape[0]
    slots = torch.arange(n_out, device=boundaries.device).expand(B, n_out).contiguous()
    cat = torch.searchsorted(boundaries.contiguous(), slots, right=True)
    starts = torch.cat([torch.zeros_like(boundaries[:, :1]), boundaries], 1)
    return cat, slots - torch.gather(starts, 1, cat)


class GuidedPointSampler:
    '''Call sample_frame per frame with the whole batch.'''

    def __init__(self, cfg: SamplerConfig):
        self.cfg = cfg
        self.cols = _COLS[cfg.data_kind]

    def _output_cube_valid(self, pcl, valid):
        '''CARLA restricts supervision to the output cuboid.'''
        if self.cfg.data_kind == 'carla':
            cub = carla_output_bounds(self.cfg.cube_bounds, self.cfg.min_z,
                                      self.cfg.cube_mode)
            valid = valid & cuboid_mask(pcl, cub)
        return valid

    # ------------------------------------------------------------------ solid --

    def _solid_shares_and_weights(self, tgt, valid, unique_valid, valo_ids,
                                  num_valo_ids):
        '''(shares (B, 6), per-bias weights [(B, M)] * 6) in sbs order (regular,
        low, moving, vehped, ivalo, sembal).'''
        cfg = self.cfg
        B = tgt.shape[0]
        z = tgt[..., 2]
        inst = tgt[..., self.cols['inst']].to(torch.int64)
        segm = tgt[..., self.cols['segm']].to(torch.int64)
        view = tgt[..., self.cols['view']].to(torch.int64)
        zero_w = torch.zeros_like(z)
        zero_s = torch.zeros((B,), dtype=torch.float32, device=tgt.device)
        f32 = lambda m: m.to(torch.float32)  # noqa: E731

        shares = [torch.ones_like(zero_s)]
        weights = [f32(valid)]

        low_mask = valid & (z >= cfg.low_prefer_min_z) & (z <= cfg.low_prefer_max_z)
        if cfg.has('low'):
            shares.append(f32(low_mask.sum(-1) >= 256))
            weights.append(f32(low_mask))
        else:
            shares.append(zero_s)
            weights.append(zero_w)

        if cfg.has('moving'):
            shares.append(_ramp_share(unique_valid.sum(-1), 0.4))
            weights.append(f32(unique_valid))
        else:
            shares.append(zero_s)
            weights.append(zero_w)

        vehped = (segm == 4) | (segm == 10)
        vehped_mask = valid & vehped
        if cfg.has('vehped'):
            shares.append(_ramp_share(vehped_mask.sum(-1), 0.2))
            weights.append(f32(vehped_mask))
        else:
            shares.append(zero_s)
            weights.append(zero_w)

        if cfg.has('ivalo'):
            R = valo_ids.shape[1]
            valo_valid = (torch.arange(R, device=tgt.device)[None]
                          < num_valo_ids[:, None])                       # (B, R).
            same = inst[..., None] == valo_ids[:, None, :].to(torch.int64)  # (B, M, R).
            is_valo = (same & valo_valid[:, None, :]).any(-1)
            vis_pts = valid & (view == 0) & vehped
            id_visible = (vis_pts[..., None] & same).any(1)                # (B, R).
            pt_id_visible = (same & id_visible[:, None, :]
                             & valo_valid[:, None, :]).any(-1)
            ivalo_mask = valid & (view != 0) & vehped & is_valo
            w = torch.where(ivalo_mask, torch.where(pt_id_visible, 1.0, 2.0),
                            torch.zeros_like(z))
            shares.append(torch.clamp(_ramp_share(w.sum(-1), 0.2), max=0.2))
            weights.append(w)
        else:
            shares.append(zero_s)
            weights.append(zero_w)

        if cfg.has('sembal'):
            cls = torch.clamp(segm, 0, _MAX_SEM_CLASSES - 1)
            counts = torch.zeros((B, _MAX_SEM_CLASSES), dtype=torch.float32,
                                 device=tgt.device).scatter_add_(1, cls, f32(valid))
            c_pt = torch.gather(counts, 1, cls)
            eligible = c_pt >= 16
            w = torch.where(valid & eligible, 1.0 / torch.clamp(c_pt, min=1.0),
                            torch.zeros_like(z))
            shares.append(torch.where(w.sum(-1) > 0, 0.4, 0.0).to(torch.float32))
            weights.append(w)
        else:
            shares.append(zero_s)
            weights.append(zero_w)

        shares = torch.stack(shares, -1)
        return shares / shares.sum(-1, keepdim=True), weights

    def _assemble_blocks(self, boundaries, pools, n_out):
        '''Contiguous-block assembly: slot i of example b belongs to category
        c = searchsorted(boundaries[b], i) and takes pools[c][b, i - start_c].
        :param boundaries (B, C-1) cumulative block ends; pools: C (B, n_out)
            index arrays. :return (B, n_out).'''
        cat, offset = _block_slots(boundaries, n_out)
        out = torch.gather(pools[0], 1, offset)
        for c in range(1, len(pools)):
            out = torch.where(cat == c, torch.gather(pools[c], 1, offset), out)
        return out

    def sample_solid(self, gen, tgt, valid, unique_valid, valo_ids, num_valo_ids,
                     time_idx):
        '''
        :return (solid_input (B, S, 4), solid_target (B, S, 6), shares (B, 6),
            sel (B, S) target rows).
        '''
        cfg = self.cfg
        S = cfg.num_solid
        shares, weights = self._solid_shares_and_weights(
            tgt, valid, unique_valid, valo_ids, num_valo_ids)
        # Blocks of floor(share * S) slots in the order low, moving, vehped,
        # ivalo, sembal; regular takes the rest.
        n_biased = torch.floor(shares[:, 1:] * S).to(torch.int64)
        pools = [masked_choice(gen, w > 0, S, weights=w)[0]
                 for w in (weights[1], weights[2], weights[3], weights[4], weights[5],
                           weights[0])]
        sel = self._assemble_blocks(torch.cumsum(n_biased, -1), pools, S)

        rows = _rows(tgt, sel)
        xyz = rows[..., :3] + sample_uniform_3ball(gen, sel.shape,
                                                   cfg.point_occupancy_radius / 2.0)
        t_col = torch.full_like(xyz[..., :1], float(time_idx))
        solid_input = torch.cat([xyz, t_col], -1)
        copy = rows[..., -4:]                                  # (R, G, B, mark).
        dens = torch.ones_like(t_col)
        if cfg.predict_segmentation:
            segm = rows[..., self.cols['segm']:self.cols['segm'] + 1]
            segm = torch.where(segm >= cfg.semantic_classes, torch.full_like(segm, 3.0),
                               segm)
        else:
            segm = -torch.ones_like(t_col)
        solid_target = torch.cat([dens, copy, segm], -1)
        return solid_input, solid_target, shares, sel

    # -------------------------------------------------------------------- air --

    def _air_pool(self, gen, base_pts, base_valid, n_cand, n_active, jitter,
                  tgt_xyz, tgt_valid, blind_cuboid=None):
        '''One air candidate pool: n_cand candidates per example (base points
        or blind uniform), jittered, rejected within r of any valid target
        point. :return (cand (B, C, 3), order (B, C), count (B,)).'''
        cfg = self.cfg
        B = tgt_xyz.shape[0]
        if blind_cuboid is not None:
            cand = sample_blind_random(gen, (B, n_cand), blind_cuboid)
        else:
            idx, _ = masked_choice(gen, base_valid, n_cand)
            cand = _rows(base_pts, idx)[..., :3]
        if jitter is not None:
            cand = cand + sample_uniform_3ball(gen, (B, n_cand), jitter[1], jitter[0])
        d = nn1_min_dist(cand, tgt_xyz, key_mask=tgt_valid)
        in_play = torch.arange(n_cand, device=cand.device)[None] < n_active[:, None]
        ok = in_play & (d > cfg.point_occupancy_radius)
        return cand, valid_first_order(ok), ok.sum(-1)

    def sample_air(self, gen, tgt, valid, other_unique, other_unique_valid,
                   solid_input, time_idx):
        '''
        :return (air_input (B, A, 4), air_target (B, A, 6), shares (B, 4),
            air_ok (B,), pool_counts (B, 4) survivors per pool).
        '''
        cfg = self.cfg
        A = cfg.num_air
        B = tgt.shape[0]
        dev = tgt.device
        tgt_xyz = tgt[..., :3].contiguous()
        r = cfg.point_occupancy_radius
        f32 = lambda v: torch.full((B,), v, dtype=torch.float32, device=dev)  # noqa: E731

        # (regular, moving, hard_solid_query, hard_target).
        mov_share = (_ramp_share(other_unique_valid.sum(-1), 0.4) if cfg.has('moving')
                     else f32(0.0))
        shares = torch.stack([f32(0.5), mov_share, f32(0.3), f32(0.2)], -1)
        shares = shares / shares.sum(-1, keepdim=True)
        n_mov, n_hsq, n_ht = (torch.floor(shares[:, i] * A).to(torch.int64)
                              for i in (1, 2, 3))
        boundaries = torch.cumsum(torch.stack([n_mov, n_hsq, n_ht], -1), -1)

        # One static capacity, the largest pool's worst case.
        reg_factor = 1.3 if cfg.data_kind == 'greater' else 1.1
        C = max(int(A * 0.4 / 1.4 * 1.6) + 8, int(A * 0.3 * 2.0) + 8,
                int(A * 0.2 * 2.0) + 8, int(A * 0.5 * reg_factor) + 8)
        blind = blind_sample_bounds(cfg.data_kind, cfg.cube_bounds, cfg.min_z,
                                    cfg.cube_mode)
        active = lambda n, f: (n.to(torch.float32) * f).to(torch.int64)  # noqa: E731
        if cfg.has('moving'):
            mov = self._air_pool(gen, other_unique, other_unique_valid, C,
                                 active(n_mov, 1.6), (0.0, 2.0 * r), tgt_xyz, valid)
        else:
            # The share is statically zero: no slot reads this pool.
            mov = (torch.zeros((B, C, 3), device=dev),
                   torch.arange(C, device=dev).expand(B, C),
                   torch.zeros((B,), dtype=torch.int64, device=dev))
        hsq = self._air_pool(gen, solid_input,
                             torch.ones(solid_input.shape[:2], dtype=torch.bool,
                                        device=dev),
                             C, active(n_hsq, 2.0), (r, 3.0 * r), tgt_xyz, valid)
        ht = self._air_pool(gen, tgt, valid, C, active(n_ht, 2.0), (r, 3.0 * r),
                            tgt_xyz, valid)
        n_reg = A - n_mov - n_hsq - n_ht
        reg = self._air_pool(gen, None, None, C, active(n_reg, reg_factor), None,
                             tgt_xyz, valid, blind_cuboid=blind)

        # Cyclic duplication within each pool; a dry biased pool falls back to
        # the regular pool's survivors, and a dry regular pool flags the frame.
        reg_cand, reg_order, reg_cnt = reg
        air_ok = reg_cnt > 0
        pool_counts = torch.stack([mov[2], hsq[2], ht[2], reg_cnt], -1)
        cat, offset = _block_slots(boundaries, A)
        air = torch.zeros((B, A, 3), dtype=torch.float32, device=dev)
        for c, (cand, order, cnt) in enumerate([mov, hsq, ht, reg]):
            dry = cnt == 0
            cand = torch.where(dry[:, None, None], reg_cand, cand)
            order = torch.where(dry[:, None], reg_order, order)
            cnt = torch.clamp(torch.where(dry, reg_cnt, cnt), min=1)
            rows = _rows(cand, torch.gather(order, 1, offset % cnt[:, None]))
            air = torch.where((cat == c)[..., None], rows, air)

        t_col = torch.full((B, A, 1), float(time_idx), dtype=torch.float32, device=dev)
        air_input = torch.cat([air, t_col], -1)
        # (density 0, R = G = B = -1, mark -1, segm -1).
        air_target = torch.cat([torch.zeros_like(t_col),
                                -torch.ones((B, A, 5), dtype=torch.float32,
                                            device=dev)], -1)
        return air_input, air_target, shares, air_ok, pool_counts

    # ------------------------------------------------------------------ frame --

    def sample_frame(self, gen, tgt, tgt_valid, other, other_valid, valo_ids,
                     num_valo_ids, time_idx):
        '''
        One frame of the whole batch.
        :param gen: torch.Generator on the tensors' device.
        :param tgt (B, M, E) padded target frame; tgt_valid (B, M) bool.
        :param other (B, M, E): a random other target frame per example.
        :param valo_ids (B, R) int; num_valo_ids (B,) int; time_idx int.
        :return dict(solid_input (B, S, 4), air_input (B, A, 4), solid_target
            (B, S, 6), air_target (B, A, 6), solid_sbs (B, 6), air_sbs (B, 4),
            ok (B,), air_pool_counts (B, 4)).
        '''
        cfg = self.cfg
        valid = self._output_cube_valid(tgt, tgt_valid)
        other_v = self._output_cube_valid(other, other_valid)
        ok = valid.sum(-1) >= 256

        if cfg.has('moving'):
            # Points of one frame farther than 2r from every point of the other.
            d_tgt, d_other = nn1_bidirectional(tgt[..., :3], other[..., :3],
                                               a_mask=valid, b_mask=other_v)
            thr = cfg.point_occupancy_radius * 2.0
            tgt_unique = valid & (d_tgt > thr)
            other_unique = other_v & (d_other > thr)
        else:
            tgt_unique = torch.zeros_like(valid)
            other_unique = torch.zeros_like(other_v)

        solid_input, solid_target, solid_sbs, _ = self.sample_solid(
            gen, tgt, valid, tgt_unique, valo_ids, num_valo_ids, time_idx)
        air_input, air_target, air_sbs, air_ok, air_pool_counts = self.sample_air(
            gen, tgt, valid, other, other_unique, solid_input, time_idx)
        return dict(solid_input=solid_input, air_input=air_input,
                    solid_target=solid_target, air_target=air_target,
                    solid_sbs=solid_sbs, air_sbs=air_sbs, ok=ok & air_ok,
                    air_pool_counts=air_pool_counts)
