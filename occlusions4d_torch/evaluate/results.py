'''
Test-result artifact management: discover, load, and merge the pcl_io_s{step}.p
pickles exported by the eval driver.

Own copy of occlusions4d_tpu/evaluate/results.py. The record layout:

  record tuple = (input, abstract, output_solid, target, output_air) with
    input        (N, 8)    (x, y, z, R, G, B, t, mark_track)
    abstract     (M, 3+E)  (x, y, z, features)
    output_solid (S, 9+)   (x, y, z, t, density, R/G/B..., mark_track, segm?)
    target       (T, 9-11) dataset target layout
    output_air   (A, 5)    (x, y, z, density, pred_segm) when compressed
'''

import os
import pathlib
import pickle

import numpy as np

__all__ = ['find_test_result_files', 'load_test_results', 'merge_steps_into_long']

_SKIP_DIR_TOKENS = ('_povvid', '_open3d')


def find_test_result_files(input_path, dir_filter=None, step_idx=None):
    '''
    :param input_path (str): prefix of one or more run log directories (the parent
        is listed and every directory whose name starts with the prefix's basename
        is searched), or a direct test-results directory.
    :param dir_filter (str): keep only test subdirectories containing this substring.
    :param step_idx (int): keep only a specific step's file.
    :return sorted list of pcl_io_s*.p file paths.
    '''
    input_path = pathlib.Path(input_path)
    parent, prefix = str(input_path.parent), str(input_path.name)
    found = []
    run_dirs = [d for d in os.listdir(parent)] if os.path.isdir(parent) else []
    for run_dn in run_dirs:
        if not run_dn.startswith(prefix):
            continue
        run_dp = os.path.join(parent, run_dn)
        if not os.path.isdir(run_dp):
            continue
        candidates = [os.path.join(run_dp, d) for d in os.listdir(run_dp)
                      if d.startswith('test_')]
        candidates.append(run_dp)  # direct test-results folder.
        for test_dp in candidates:
            if not os.path.isdir(test_dp):
                continue
            if any(tok in test_dp for tok in _SKIP_DIR_TOKENS):
                continue
            if dir_filter is not None and dir_filter not in test_dp:
                continue
            for fn in os.listdir(test_dp):
                if not (fn.startswith('pcl_io_') and fn.endswith('.p')):
                    continue
                if step_idx is not None and f'_s{step_idx}.' not in fn:
                    continue
                found.append(os.path.join(test_dp, fn))
    return sorted(found)


def load_test_results(input_path, dir_filter=None, step_inds=None):
    '''
    Load per-step pcl_all lists in step order (steps are
    read contiguously from 0 until the first missing index).
    :return list of pcl_all (one per test step; each a list of per-frame records).
    '''
    files = find_test_result_files(input_path, dir_filter=dir_filter)
    out = []
    step_idx = 0
    while True:
        if step_inds is not None and step_idx not in step_inds:
            break
        matches = [fp for fp in files if f'_s{step_idx}.p' in fp]
        if not matches and (step_inds is None or step_idx > max(step_inds)):
            break
        with open(matches[0], 'rb') as f:
            out.append(pickle.load(f))
        step_idx += 1
    return out


def merge_steps_into_long(pcl_all_list, last_minus=0):
    '''
    Stitch one selected frame per test step into a single long video: the
    chosen output/target frame of every clip is re-stamped with the step index as its time coordinate, and the first entry's input cloud is
    replaced by the concatenation of all selected inputs.
    :param last_minus (int): 0 selects each clip's last frame, 1 the one before, ...
    :return list of (input, abstract, output_solid, target, output_air) per step.
    '''
    long_list = []
    for i, step_pcl_all in enumerate(pcl_all_list):
        pcl_input = step_pcl_all[0][0]
        pcl_abstract = step_pcl_all[0][1]
        input_frames = len(np.unique(pcl_input[..., -2]))

        sel_input = pcl_input[pcl_input[..., -2] == input_frames - 1 - last_minus].copy()
        frame = step_pcl_all[-1 - last_minus]
        sel_solid = np.array(frame[2])
        sel_input[..., -2] = i       # input time channel.
        sel_solid[..., 3] = i        # output query time channel.
        long_list.append([sel_input, pcl_abstract, sel_solid, frame[3], frame[4]])

    long_list[0][0] = np.concatenate([rec[0] for rec in long_list], axis=0)
    return long_list
