'''
Observability (own copy of occlusions4d_tpu/utils/logvis.py): file + stream
logging, scalar memory with deferred per-epoch commit, artifact export
(pickle / npy / json / png), optional wandb, and the training-step reporter.

wandb is optional and imported lazily: everything degrades to file / npy
logging when it is unavailable or disabled. PNG artifacts go through
data/png.py (no imaging package needed); the JAX package's save_video (mp4 /
gif through imageio) is not part of the port.
'''

import json
import logging
import os
import pickle
import sys

import numpy as np

__all__ = ['Logger', 'StepLogger']


class Logger:
    '''Generic logging helper; one instance per (train|test) context.'''

    def __init__(self, log_dir=None, context='main', use_wandb=False):
        self.log_dir = log_dir
        self.context = context
        self.use_wandb = use_wandb
        self.wandb = None
        self.scalar_memory = {}          # name -> list of values (deferred commit).
        self.scalar_memory_hist = set()  # names committed as histograms.
        self.scalar_history = []         # per-epoch committed means (scalars.json).
        self._initialized = False

        self.logger = logging.getLogger(f'o4d_torch.{context}.{id(self):x}')
        self.logger.setLevel(logging.INFO)
        self.logger.propagate = False
        fmt = logging.Formatter('%(asctime)s %(levelname)s %(message)s')
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        self.logger.addHandler(sh)
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            fh = logging.FileHandler(os.path.join(log_dir, context + '.log'))
            fh.setFormatter(fmt)
            self.logger.addHandler(fh)

    # -- plain logging ------------------------------------------------------------

    def info(self, msg=''):
        self.logger.info(msg)

    def warning(self, msg=''):
        self.logger.warning(msg)

    def error(self, msg=''):
        self.logger.error(msg)

    def exception(self, e):
        self.logger.exception(e)

    def debug(self, msg=''):
        self.logger.debug(msg)

    # -- wandb --------------------------------------------------------------------

    def init_wandb(self, project, args, networks=None, name=None):
        if not self.use_wandb:
            return
        try:
            import wandb
            wandb.init(project=project, name=name or getattr(args, 'name', None),
                       config={k: v for k, v in vars(args).items()
                               if isinstance(v, (int, float, str, bool))})
            self.wandb = wandb
        except Exception as e:  # no network, or no wandb package.
            self.warning(f'wandb unavailable, falling back to file logging: {e}')
            self.use_wandb = False

    # -- scalars / histograms -------------------------------------------------------

    def report_scalar(self, name, value, step=None, remember=False,
                      commit_histogram=False):
        '''Immediate or accumulated scalar.'''
        value = float(value)
        if remember:
            self.scalar_memory.setdefault(name, []).append(value)
            if commit_histogram:
                self.scalar_memory_hist.add(name)
        elif self.wandb is not None:
            self.wandb.log({name: value}, step=step)

    def commit_scalars(self, step=None):
        '''Deferred mean / histogram commit.'''
        out = {}
        for name, values in self.scalar_memory.items():
            if not values:
                continue
            if name in self.scalar_memory_hist:
                out[name + '_hist'] = list(values)
            out[name] = float(np.mean(values))
        if self.wandb is not None and out:
            self.wandb.log(out, step=step)
        for values in self.scalar_memory.values():
            values.clear()
        return out

    def report_histogram(self, name, values, step=None):
        if self.wandb is not None:
            self.wandb.log({name: self.wandb.Histogram(np.asarray(values))}, step=step)

    def epoch_finished(self, epoch):
        out = self.commit_scalars(step=epoch)
        # Persist the per-epoch committed means (the file-mode equivalent of
        # a wandb scalar timeline); scalar_history survives in memory for
        # programmatic consumers.
        self.scalar_history.append(
            dict({k: v for k, v in out.items() if not k.endswith('_hist')},
                 epoch=epoch))
        if self.log_dir is not None:
            with open(os.path.join(self.log_dir, 'scalars.json'), 'w') as f:
                json.dump(self.scalar_history, f, indent=1)

    # -- artifacts -------------------------------------------------------------------

    def _artifact_dir(self, sub, folder=None):
        assert self.log_dir is not None, 'Logger has no log_dir for artifacts.'
        d = os.path.join(self.log_dir, folder if folder is not None else sub)
        os.makedirs(d, exist_ok=True)
        return d

    def save_args(self, args):
        if self.log_dir is None:
            return
        d = {k: v for k, v in vars(args).items()
             if isinstance(v, (int, float, str, bool, list, tuple, type(None)))}
        with open(os.path.join(self.log_dir, f'args_{self.context}.json'), 'w') as f:
            json.dump(d, f, indent=2)

    def save_pickle(self, obj, file_name, folder=None):
        fp = os.path.join(self._artifact_dir('pickle', folder), file_name)
        with open(fp, 'wb') as f:
            pickle.dump(obj, f, protocol=4)
        return fp

    def save_numpy(self, arr, file_name, step=None, folder=None):
        fn = file_name if step is None else f'{file_name}_s{step}'
        fp = os.path.join(self._artifact_dir('numpy', folder), fn + '.npy')
        np.save(fp, np.asarray(arr))
        return fp

    # -- visual artifacts ------------------------------------

    @staticmethod
    def _to_uint8(img):
        img = np.asarray(img)
        if img.dtype in (np.float32, np.float64):
            img = (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
        return img

    def save_image(self, img, file_name, step=None, folder=None, wandb_name=None):
        '''Save an (H, W[, 3]) image as png; optionally mirror to wandb.'''
        from ..data.png import write_png
        fn = file_name if step is None else f'{file_name}_s{step}'
        fp = os.path.join(self._artifact_dir('visuals', folder), fn + '.png')
        img = self._to_uint8(img)
        write_png(fp, img)
        if self.wandb is not None and wandb_name is not None:
            self.wandb.log({wandb_name: self.wandb.Image(img)}, step=step)
        return fp

    def save_gallery(self, frames, file_name, step=None, folder=None,
                     num_cols=None, wandb_name=None):
        '''Tile (T, H, W, 3) frames into one grid image.'''
        frames = np.stack([self._to_uint8(f) for f in np.asarray(frames)])
        (T, H, W) = frames.shape[:3]
        cols = num_cols or int(np.ceil(np.sqrt(T)))
        rows = -(-T // cols)
        pad = rows * cols - T
        if pad:
            frames = np.concatenate(
                [frames, np.zeros((pad,) + frames.shape[1:], frames.dtype)])
        grid = frames.reshape(rows, cols, H, W, -1)
        grid = grid.transpose(0, 2, 1, 3, 4).reshape(rows * H, cols * W, -1)
        return self.save_image(grid.squeeze(), file_name, step=step, folder=folder,
                               wandb_name=wandb_name)


class StepLogger(Logger):
    '''Training-step reporter: console loss breakdown, npy point-cloud
    export, per-channel output histograms.'''

    def __init__(self, log_dir=None, context='train', use_wandb=False, batch_size=1):
        super().__init__(log_dir, context, use_wandb)
        self.step_interval = max(160 // max(batch_size, 1), 1)
        self.num_exported = 0

    def handle_step(self, epoch, stage, cur_step, total_step, steps_per_epoch,
                    total_loss, loss_terms=None, export_arrays=None):
        '''
        :param loss_terms (dict): name -> float loss breakdown.
        :param export_arrays (dict): name -> numpy array point clouds; exported
            whenever given (the caller controls the cadence).
        '''
        if cur_step % self.step_interval == 0:
            terms = '  '.join(f'{k}: {v:.4f}' for k, v in (loss_terms or {}).items()
                              if isinstance(v, float))
            self.info(f'[{stage}] epoch {epoch}  step {cur_step}/{steps_per_epoch}  '
                      f'total_loss: {float(total_loss):.4f}  {terms}')
        if export_arrays:
            self.export_pointclouds(stage, epoch, total_step, export_arrays)

    def export_pointclouds(self, stage, epoch, step, arrays):
        '''npy export of named point clouds under <log_dir>/numpy.'''
        if self.log_dir is None:
            return []
        fps = [self.save_numpy(arr, f'{stage}_{name}_e{epoch}', step=step)
               for name, arr in arrays.items()]
        self.num_exported += 1
        return fps

    def report_filter_ratios(self, stage, meta_list, epoch):
        '''Dataset point-filtering ratio histograms, accumulated over the epoch and
        committed as histograms; outliers > 10 are dropped to
        keep the histogram resolution useful.'''
        for meta in meta_list or []:
            for key in ('cuboid_filter_ratios', 'sample_input_ratios',
                        'sample_target_ratios'):
                for ratio in np.asarray(meta.get(key, ()), np.float32).flatten():
                    if ratio <= 10.0:
                        self.report_scalar(f'{stage}/{key[:-1]}', float(ratio),
                                           step=epoch, remember=True,
                                           commit_histogram=True)

    def report_implicit_histograms(self, stage, implicit_output, color_mode, time_idx,
                                   predict_segmentation, semantic_classes,
                                   predict_tracking, step):
        '''Per-channel distribution summaries: density, color,
        track, segmentation.'''
        io = np.asarray(implicit_output)
        self.report_histogram(f'{stage}/density_t{time_idx}', io[..., 0], step=step)
        q = {'rgb': 3, 'rgb_nosigmoid': 3, 'hsv': 14, 'bins': 9}[color_mode]
        self.report_histogram(f'{stage}/color_t{time_idx}', io[..., 1:1 + q], step=step)
        if predict_tracking:
            self.report_histogram(f'{stage}/track_t{time_idx}', io[..., 1 + q], step=step)
        if predict_segmentation:
            self.report_histogram(f'{stage}/segm_t{time_idx}',
                                  io[..., -semantic_classes:], step=step)

    def _feature_histograms(self, prefix, feats, color_mode, predict_segmentation,
                            semantic_classes, predict_tracking, step):
        '''Per-channel histograms of a (N, 5+) feature block
        (density, color..., mark_track, segm?).'''
        if feats.shape[0] == 0:
            return
        self.report_histogram(f'{prefix}_dens', feats[..., 0], step=step)
        if color_mode in ('rgb', 'rgb_nosigmoid'):
            for i, ch in enumerate(('red', 'green', 'blue')):
                self.report_histogram(f'{prefix}_{ch}', feats[..., 1 + i], step=step)
            q = 3
        elif color_mode == 'hsv':
            self.report_histogram(f'{prefix}_clr_hue',
                                  feats[..., 1:13].argmax(axis=-1), step=step)
            self.report_histogram(f'{prefix}_clr_sat', feats[..., 13], step=step)
            self.report_histogram(f'{prefix}_clr_val', feats[..., 14], step=step)
            q = 14
        elif color_mode == 'bins':
            self.report_histogram(f'{prefix}_clr_bin',
                                  feats[..., 1:10].argmax(axis=-1), step=step)
            q = 9
        else:
            raise ValueError(color_mode)
        if predict_tracking:
            self.report_histogram(f'{prefix}_mark_track', feats[..., 1 + q], step=step)
        if predict_segmentation:
            self.report_histogram(f'{prefix}_segm',
                                  feats[..., -semantic_classes:].argmax(axis=-1),
                                  step=step)

    def report_pcl_air_histograms(self, stage, pcl_output, air_output, color_mode,
                                  time_idx, predict_segmentation, semantic_classes,
                                  predict_tracking, has_xyzt, step):
        '''
        Per-channel histograms of the predicted-SOLID vs predicted-AIR split.
        :param pcl_output (S, 5+) or (S, 4+5+) with leading (x, y, z, t) when
            has_xyzt: solid-side rows (density, color..., mark_track, segm?).
        :param air_output: air-side rows; may be compressed to
            (A, 3+1[+1]) = (x, y, z, density[, pred_segm]) at eval, or None.
        '''
        pcl_output = np.asarray(pcl_output)
        if has_xyzt:
            self.report_histogram(f'{stage}/pcl_xyz', pcl_output[..., :3], step=step)
            pcl_output = pcl_output[..., 4:]
            if air_output is not None:
                air_output = np.asarray(air_output)
                self.report_histogram(f'{stage}/air_xyz', air_output[..., :3],
                                      step=step)
                air_output = air_output[..., 3:]
        self._feature_histograms(f'{stage}/pcl', pcl_output, color_mode,
                                 predict_segmentation, semantic_classes,
                                 predict_tracking, step)
        if air_output is not None:
            air_output = np.asarray(air_output)
            if air_output.shape[0]:  # air side: density only.
                self.report_histogram(f'{stage}/air_dens', air_output[..., 0],
                                      step=step)
