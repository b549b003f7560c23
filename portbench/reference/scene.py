'''
The reference dense scene: encode one cloud (FPS from point 0), evaluate the
field on every query of the grid in blocks, and squash the outputs as the
evaluation does (density, colour and semantics to probabilities; the track
channel stays a logit with track mode 'none').
'''

import torch

from .models import build_models
from .train import load_weights

# Queries a block: the plain decoder holds (block, K, D) rows per layer.
BLOCK = 32768


class SceneReference:
    '''The networks of `cfg` on `device` with the given weights, in eval mode.'''

    def __init__(self, cfg, weights, device):
        self.cfg = cfg
        self.encoder, self.decoder = build_models(cfg)
        self.encoder.to(device).eval()
        self.decoder.to(device).eval()
        load_weights(self, weights)
        self.device = torch.device(device)

    @torch.no_grad()
    def encode(self, pcl):
        '''pcl (N, 8) float32 numpy -> (abstract (M, 3 + E), global (G,)).'''
        x = torch.as_tensor(pcl, dtype=torch.float32, device=self.device)[None]
        abstract, fg = self.encoder(x)
        return abstract[0], fg[0]

    @torch.no_grad()
    def decode(self, queries, abstract, fg):
        '''queries (P, 4) numpy -> squashed outputs (P, C) on the device.'''
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        outs = []
        for c0 in range(0, q.shape[0], BLOCK):
            out = self.decoder(q[None, c0:c0 + BLOCK], abstract[None], fg[None])[0]
            outs.append(squash_eval(out, self.cfg))
        return torch.cat(outs, 0)


def squash_eval(out, cfg):
    out = out.clone()
    out[..., 0] = torch.sigmoid(out[..., 0])
    if cfg['color_mode'] == 'rgb':
        out[..., 1:4] = torch.sigmoid(out[..., 1:4])
    elif cfg['color_mode'] == 'rgb_nosigmoid':
        out[..., 1:4] = torch.clamp(out[..., 1:4], 0.0, 1.0)
    else:
        raise ValueError(f'the reference has no color mode {cfg["color_mode"]!r}')
    if cfg['segmentation_lw'] > 0.0:
        n = cfg['semantic_classes']
        out[..., -n:] = torch.sigmoid(out[..., -n:])
    return out
