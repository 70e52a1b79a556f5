"""KITTI tracking sequence viewer: offline bird's-eye and 3D renders.

    python -m jmodt_torch.tools.viewer --root_dir KITTI/tracking/training
        --seq 0 --label_dir output/mot_data/val --output_dir viz
        [--view bev|3d|both] [--video out.mp4] [--no_labels]

The counterpart of `tools/visualization/viewer.py` (reference
tools/visualization/viewer.py, whose open3d window is replaced by
matplotlib's Agg renderer), host only:

  * BEV (`render_frame`): the point cloud from above, box footprints and
    each track's recent trajectory, a stable color a track id;
  * 3D (`render_frame_3d`): every LiDAR point that projects into image_02
    painted with its pixel's RGB, 12-edge wireframe boxes and each track's
    3D trajectory of box centres, on an mplot3d axis.

`create_video` stitches the PNGs into an mp4 with cv2.  matplotlib and
cv2 are imported where they are used, and images are read by
`utils/png.py`, so the module imports without them.
"""

import argparse
import os
from collections import defaultdict

import numpy as np

from jmodt_torch.utils.calibration import Calibration
from jmodt_torch.utils.kitti_io import _corners3d
from jmodt_torch.utils.png import read_png_rgb

BOX_LINES = [[0, 1], [1, 2], [2, 3], [3, 0], [4, 5], [5, 6], [6, 7], [7, 4],
             [0, 4], [1, 5], [2, 6], [3, 7]]


def get_labels(file_path, classes=('Car', 'Van')):
    """{frame: [(tid, box3d)]} from a KITTI tracking txt
    (reference viewer.py:68-90)."""
    box_data = defaultdict(list)
    all_ids = []
    with open(file_path) as f:
        for line in f:
            fields = line.split()
            if len(fields) < 17 or fields[2] not in classes:
                continue
            frame = int(float(fields[0]))
            tid = int(float(fields[1]))
            if tid == -1:
                continue
            box = np.array([float(v) for v in fields[13:16]]
                           + [float(fields[10]), float(fields[11]),
                              float(fields[12]), float(fields[16])],
                           np.float32)  # x y z h w l ry
            box_data[frame].append((tid, box))
            all_ids.append(tid)
    return box_data, all_ids


class KittiSequenceViewer:
    """Offline (matplotlib) sequence renderer."""

    def __init__(self, root_dir, seq, output_dir, label_dir,
                 classes=('Car', 'Van'), trajectory_len=15):
        self.root_dir = root_dir
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.trajectory_len = trajectory_len
        self.seq = str(int(seq)).zfill(4)
        self.calib = Calibration(
            os.path.join(root_dir, 'calib', f'{self.seq}.txt'))
        self.box_data, all_ids = get_labels(
            os.path.join(label_dir, f'{self.seq}.txt'), classes)
        lidar_dir = os.path.join(root_dir, 'velodyne', self.seq)
        self.lidar_dir = lidar_dir
        self.frames = sorted(f[:-4] for f in os.listdir(lidar_dir))
        # stable per-tid colors (reference viewer.py:40-46)
        import matplotlib
        rng = np.random.RandomState(0)
        ids = sorted(set(all_ids))
        order = rng.permutation(len(ids))
        cmap = matplotlib.colormaps['gist_rainbow'].resampled(
            max(len(ids), 1))
        self.id_color = {tid: cmap(order[i]) for i, tid in enumerate(ids)}
        self.history = defaultdict(list)

    def get_lidar(self, frame):
        pts = np.fromfile(os.path.join(self.lidar_dir, f'{frame}.bin'),
                          dtype=np.float32).reshape(-1, 4)
        return pts[:, :3]

    def get_painted_point_cloud(self, frame):
        """Rect-frame points colored by their image_02 pixel RGB (reference
        get_painted_point_cloud, viewer.py:92-110, vectorized instead of the
        per-point python loop).  Returns (pts_rect (N, 3), colors (N, 3)) —
        only points that project inside the image with positive depth."""
        img_path = os.path.join(self.root_dir, 'image_02', self.seq,
                                f'{frame}.png')
        img = read_png_rgb(img_path).astype(np.float32) / 255.0
        pts_rect = self.calib.lidar_to_rect(self.get_lidar(frame))
        pts_img, pts_depth = self.calib.rect_to_img(pts_rect)
        h, w = img.shape[:2]
        u = np.round(pts_img[:, 0]).astype(np.int64) - 1
        v = np.round(pts_img[:, 1]).astype(np.int64) - 1
        valid = ((u >= 0) & (u < w) & (v >= 0) & (v < h)
                 & (pts_depth > 0))
        return pts_rect[valid], img[v[valid], u[valid]]

    def render_frame(self, frame, show_labels=True, path=None):
        """One BEV PNG: painted points + boxes + trajectories."""
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt

        pts_rect = self.calib.lidar_to_rect(self.get_lidar(frame))
        keep = (pts_rect[:, 2] > 0) & (pts_rect[:, 2] < 80) & \
               (np.abs(pts_rect[:, 0]) < 40)
        pts_rect = pts_rect[keep]

        fig, ax = plt.subplots(figsize=(8, 8), facecolor='black')
        ax.set_facecolor('black')
        ax.scatter(pts_rect[:, 0], pts_rect[:, 2], s=0.2,
                   c=np.clip(pts_rect[:, 2] / 80, 0, 1), cmap='viridis')
        f_int = int(frame)
        if show_labels:
            for tid, box in self.box_data.get(f_int, []):
                color = self.id_color.get(tid, (1, 1, 1, 1))
                corners = _corners3d(box[None])[0]  # (8, 3)
                bev = corners[:4][:, [0, 2]]
                poly = np.vstack([bev, bev[:1]])
                ax.plot(poly[:, 0], poly[:, 1], color=color, lw=1.5)
                ax.text(box[0], box[2] + 1.2, str(tid), color=color,
                        fontsize=7)
                self.history[tid].append((f_int, box[0], box[2]))
            for tid, hist in self.history.items():
                recent = [(x, z) for (fr, x, z) in hist
                          if f_int - fr <= self.trajectory_len]
                if len(recent) >= 2:
                    arr = np.array(recent)
                    ax.plot(arr[:, 0], arr[:, 1],
                            color=self.id_color.get(tid, (1, 1, 1, 1)),
                            lw=0.8, alpha=0.7)
        ax.set_xlim(-40, 40)
        ax.set_ylim(0, 80)
        ax.set_aspect('equal')
        ax.axis('off')
        path = path or os.path.join(self.output_dir, f'{frame}.png')
        fig.savefig(path, dpi=120, facecolor='black',
                    bbox_inches='tight')
        plt.close(fig)
        return path

    def _trajectories_for_frame(self, f_int):
        """{tid: (K, 3) rect-frame centers, current first} for tids visible
        in frame f_int, looking back trajectory_len frames (reference
        create_boxes_and_trajectories, viewer.py:112-141)."""
        def center(box):  # KITTI location is the bottom face center
            return np.array([box[0], box[1] - box[3] / 2, box[2]])

        track_dict = {tid: [center(box)]
                      for tid, box in self.box_data.get(f_int, [])}
        min_frame = max(0, f_int - self.trajectory_len)
        for cur in range(f_int - 1, min_frame - 1, -1):
            for tid, box in self.box_data.get(cur, []):
                if tid in track_dict:
                    track_dict[tid].append(center(box))
        return {tid: np.vstack(c) for tid, c in track_dict.items()
                if len(c) >= 2}

    def render_frame_3d(self, frame, show_labels=True, path=None,
                        max_points=60000):
        """One 3D PNG: image-painted point cloud + 3D wireframe boxes +
        per-tid trajectory lines (reference viewer.py:92-152 on mplot3d)."""
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt

        pts, colors = self.get_painted_point_cloud(frame)
        keep = (pts[:, 2] > 0) & (pts[:, 2] < 70) & (np.abs(pts[:, 0]) < 35)
        pts, colors = pts[keep], colors[keep]
        if len(pts) > max_points:
            sel = np.random.RandomState(0).choice(len(pts), max_points,
                                                  replace=False)
            pts, colors = pts[sel], colors[sel]

        fig = plt.figure(figsize=(12, 7), facecolor='black')
        ax = fig.add_subplot(111, projection='3d', facecolor='black')
        # rect frame: x right, y DOWN, z forward -> plot (x, z, -y) so up
        # is up on screen
        ax.scatter(pts[:, 0], pts[:, 2], -pts[:, 1], s=0.3, c=colors,
                   depthshade=False)
        f_int = int(frame)
        if show_labels:
            for tid, box in self.box_data.get(f_int, []):
                color = self.id_color.get(tid, (1, 1, 1, 1))
                corners = _corners3d(box[None])[0]  # (8, 3) rect frame
                for a, b in BOX_LINES:
                    seg = corners[[a, b]]
                    ax.plot(seg[:, 0], seg[:, 2], -seg[:, 1],
                            color=color, lw=1.2)
                ax.text(box[0], box[2], -(box[1] - box[3]) + 0.4, str(tid),
                        color=color, fontsize=7)
            for tid, centers in self._trajectories_for_frame(f_int).items():
                color = self.id_color.get(tid, (1, 1, 1, 1))
                ax.plot(centers[:, 0], centers[:, 2], -centers[:, 1],
                        color=color, lw=1.4, alpha=0.8)
        ax.set_xlim(-35, 35)
        ax.set_ylim(0, 70)
        ax.set_zlim(-3, 12)
        ax.set_box_aspect((70, 70, 15))
        ax.view_init(elev=22, azim=-90)  # behind the ego camera, looking +z
        ax.set_axis_off()
        path = path or os.path.join(self.output_dir, f'{frame}_3d.png')
        fig.savefig(path, dpi=120, facecolor='black', bbox_inches='tight')
        plt.close(fig)
        return path

    def visualize(self, frames=None, show_labels=True, view='bev'):
        """Render the sequence (reference visualize, viewer.py:165-182).
        view: 'bev' | '3d' | 'both'."""
        for frame in (frames or self.frames):
            if view in ('bev', 'both'):
                self.render_frame(frame, show_labels)
            if view in ('3d', 'both'):
                self.render_frame_3d(frame, show_labels)


def create_video(img_dir, video_name, size=None, fps=10):
    """PNG frames -> mp4 (reference create_video, viewer.py:184-191)."""
    import cv2
    images = sorted(f for f in os.listdir(img_dir) if f.endswith('.png'))
    if not images:
        raise FileNotFoundError(f'no frames in {img_dir}')
    first = cv2.imread(os.path.join(img_dir, images[0]))
    size = size or (first.shape[1], first.shape[0])
    video = cv2.VideoWriter(video_name,
                            cv2.VideoWriter_fourcc(*'mp4v'), fps, size)
    for image in images:
        frame = cv2.imread(os.path.join(img_dir, image))
        video.write(cv2.resize(frame, size))
    video.release()
    return video_name


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--root_dir', required=True,
                        help='KITTI tracking training/testing dir')
    parser.add_argument('--seq', type=int, default=0)
    parser.add_argument('--label_dir', required=True,
                        help='dir of per-seq tracking txt files')
    parser.add_argument('--output_dir', default='viz')
    parser.add_argument('--video', default=None,
                        help='also write an mp4 to this path')
    parser.add_argument('--no_labels', action='store_true')
    parser.add_argument('--view', choices=('bev', '3d', 'both'),
                        default='bev')
    args = parser.parse_args(argv)

    viewer = KittiSequenceViewer(args.root_dir, args.seq, args.output_dir,
                                 args.label_dir)
    viewer.visualize(show_labels=not args.no_labels, view=args.view)
    if args.video:
        create_video(args.output_dir, args.video)


if __name__ == '__main__':
    main()
