"""KITTI tracking -> detection-style layout converter (counterpart of
`jmodt_tpu/data/converter.py` and `tools/kitti_converter.py`).

Usage: python -m jmodt_torch.data.converter --data_root <KITTI root>
reads `<root>/tracking` and writes `<root>/tracking_object`.

Port of reference tools/kitti_converter.py: flattens the per-sequence
tracking dataset into a `tracking_object/` tree with globally-renumbered
6-digit sample ids, remaps per-sequence track ids to globally-unique tids
appended as the 16th label field (kitti_converter.py:56-79), and writes
`sample2frame.txt` / `seq2sample.txt` plus the ImageSets splits —
train/small_val as consecutive-pair lists, val/test flat
(kitti_converter.py:127-143, 215-219).
"""

from __future__ import annotations

import argparse
import os
import shutil

from jmodt_torch.config import (SMALL_VAL_SEQ_ID, TEST_SEQ_ID, TRAIN_SEQ_ID,
                              VALID_SEQ_ID)


def _init_or_clear_dir(path: str) -> None:
    os.makedirs(path, exist_ok=True)
    for f in os.listdir(path):
        os.remove(os.path.join(path, f))


def create_train_sample_data(input_root: str, output_root: str,
                             init_or_clear_dirs: bool = True,
                             only_labels: bool = False,
                             num_seqs: int = 21) -> None:
    """Reference create_train_sample_data (kitti_converter.py:21-143)."""
    res_training = os.path.join(output_root, 'training')
    res = {name: os.path.join(res_training, name)
           for name in ('calib', 'image_2', 'label_2', 'velodyne')}
    if init_or_clear_dirs:
        for d in res.values():
            _init_or_clear_dir(d)
    in_training = os.path.join(input_root, 'training')

    sample_id = 0
    used_tid = 0
    tid_dict = {}
    sample_to_frame = {}
    seq_to_sample = {}

    for seq_i in range(num_seqs):
        seq = '%04d' % seq_i
        t_image = os.path.join(in_training, 'image_02', seq)
        t_lidar = os.path.join(in_training, 'velodyne', seq)
        t_calib = os.path.join(in_training, 'calib', f'{seq}.txt')
        t_label = os.path.join(in_training, 'label_02', f'{seq}.txt')
        if not os.path.isdir(t_lidar):
            continue  # tolerate partial datasets (the reference asserts)
        frames = sorted(f.split('.')[0] for f in os.listdir(t_lidar))

        label_dict = {frame: [] for frame in frames}
        with open(t_label) as f:
            for line in f:
                split = line.strip().split()
                if not split:
                    continue
                frame = split[0].zfill(6)
                if frame not in label_dict:
                    continue
                tid = int(split[1])
                if tid != -1:
                    key = f'{seq}_{tid}'
                    if key not in tid_dict:
                        used_tid += 1
                        tid_dict[key] = used_tid
                    tid = tid_dict[key]
                label_dict[frame].append(
                    ' '.join(split[2:]) + f' {tid}\n')

        for frame in frames:
            s = str(sample_id).zfill(6)
            if not only_labels:
                shutil.copyfile(os.path.join(t_image, f'{frame}.png'),
                                os.path.join(res['image_2'], f'{s}.png'))
                shutil.copyfile(os.path.join(t_lidar, f'{frame}.bin'),
                                os.path.join(res['velodyne'], f'{s}.bin'))
                shutil.copyfile(t_calib,
                                os.path.join(res['calib'], f'{s}.txt'))
            with open(os.path.join(res['label_2'], f'{s}.txt'), 'w') as f:
                f.writelines(label_dict[frame])
            sample_to_frame[s] = (seq, frame)
            seq_to_sample.setdefault(seq, []).append(s)
            sample_id += 1

    _write_maps(res_training, sample_id, sample_to_frame, seq_to_sample,
                [('%04d' % i) for i in range(num_seqs)])

    split_dir = os.path.join(output_root, 'ImageSets')
    os.makedirs(split_dir, exist_ok=True)
    with open(os.path.join(split_dir, 'train.txt'), 'w') as f:
        for seq in TRAIN_SEQ_ID:
            samples = seq_to_sample.get(seq, [])
            for i in range(len(samples) - 1):
                f.write(f'{samples[i]} {samples[i + 1]}\n')
    with open(os.path.join(split_dir, 'val.txt'), 'w') as f:
        for seq in VALID_SEQ_ID:
            for s in seq_to_sample.get(seq, []):
                f.write(f'{s}\n')
    with open(os.path.join(split_dir, 'small_val.txt'), 'w') as f:
        for seq in SMALL_VAL_SEQ_ID:
            samples = seq_to_sample.get(seq, [])
            for i in range(len(samples) - 1):
                f.write(f'{samples[i]} {samples[i + 1]}\n')


def create_test_sample_data(input_root: str, output_root: str,
                            init_or_clear_dirs: bool = True,
                            seq_ids=TEST_SEQ_ID) -> None:
    """Reference create_test_sample_data (kitti_converter.py:146-219)."""
    out_test = os.path.join(output_root, 'testing')
    res = {name: os.path.join(out_test, name)
           for name in ('calib', 'image_2', 'velodyne')}
    if init_or_clear_dirs:
        for d in res.values():
            _init_or_clear_dir(d)
    in_test = os.path.join(input_root, 'testing')

    sample_id = 0
    sample_to_frame = {}
    seq_to_sample = {}
    for seq in seq_ids:
        t_image = os.path.join(in_test, 'image_02', seq)
        t_lidar = os.path.join(in_test, 'velodyne', seq)
        t_calib = os.path.join(in_test, 'calib', f'{seq}.txt')
        frames = sorted(f.split('.')[0] for f in os.listdir(t_lidar))
        for frame in frames:
            s = str(sample_id).zfill(6)
            shutil.copyfile(os.path.join(t_image, f'{frame}.png'),
                            os.path.join(res['image_2'], f'{s}.png'))
            shutil.copyfile(os.path.join(t_lidar, f'{frame}.bin'),
                            os.path.join(res['velodyne'], f'{s}.bin'))
            shutil.copyfile(t_calib, os.path.join(res['calib'], f'{s}.txt'))
            sample_to_frame[s] = (seq, frame)
            seq_to_sample.setdefault(seq, []).append(s)
            sample_id += 1

    _write_maps(out_test, sample_id, sample_to_frame, seq_to_sample, seq_ids)
    split_dir = os.path.join(output_root, 'ImageSets')
    os.makedirs(split_dir, exist_ok=True)
    with open(os.path.join(split_dir, 'test.txt'), 'w') as f:
        for seq in seq_ids:
            for s in seq_to_sample.get(seq, []):
                f.write(f'{s}\n')


def _write_maps(out_dir, n_samples, sample_to_frame, seq_to_sample, seqs):
    with open(os.path.join(out_dir, 'sample2frame.txt'), 'w') as f:
        for i in range(n_samples):
            s = str(i).zfill(6)
            seq, frame = sample_to_frame[s]
            f.write(f'{s} {seq} {frame}\n')
    with open(os.path.join(out_dir, 'seq2sample.txt'), 'w') as f:
        for seq in seqs:
            f.write(f'{seq} ' + ' '.join(seq_to_sample.get(seq, []))
                    + (' \n' if seq_to_sample.get(seq) else '\n'))


def read_seq2sample(path: str) -> dict:
    """Parse seq2sample.txt -> {seq: [sample ids]} (used by eval stage 2,
    reference tools/eval.py:345-348)."""
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts:
                out[parts[0]] = parts[1:]
    return out


def read_sample2frame(path: str) -> dict:
    """Parse sample2frame.txt -> {sample: (seq, frame)}."""
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 3:
                out[parts[0]] = (parts[1], parts[2])
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='flatten KITTI tracking into tracking_object/')
    parser.add_argument('--data_root', type=str, default='data/KITTI')
    parser.add_argument('--skip_test', action='store_true',
                        help='convert only the training sequences')
    args = parser.parse_args(argv)
    in_dir = os.path.join(args.data_root, 'tracking')
    out_dir = os.path.join(args.data_root, 'tracking_object')
    create_train_sample_data(input_root=in_dir, output_root=out_dir)
    if not args.skip_test:
        create_test_sample_data(input_root=in_dir, output_root=out_dir)


if __name__ == '__main__':
    main()
