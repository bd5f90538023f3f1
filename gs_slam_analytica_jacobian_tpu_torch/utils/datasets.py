"""Dataset ingestion: Replica / TUM / EuRoC (+ synthetic for tests) —
the port's copy of utils/datasets.py, numpy on the host; the frontend
uploads frames to the device.

PIL (PNG/JPEG decode) and cv2 (undistortion, SGBM stereo) are imported
only where a file-backed or stereo path needs them, so the module, the
synthetic RGB-D datasets and the parsers run without either. Synthetic
frames are bit-equal to the JAX package's.

__getitem__ -> (image (3,H,W) float32 in [0,1], depth (H,W) float32 or
None, w2c pose (4,4) float64) — same contract as the reference
(dataset.py:257-278) but w2c stays on host.
"""

from __future__ import annotations

import csv
import glob
import os

import numpy as np

from ..ops.camera_math import focal2fov


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading image files needs PIL (pillow)") from e
    return Image


def _cv2(what: str):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{what} needs cv2 (opencv-python)") from e
    return cv2


def _cv2_or_none():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _quat_matrix_wxyz(q):
    """4x4 homogeneous rotation from (w, x, y, z) quaternion (replaces
    trimesh.transformations.quaternion_matrix)."""
    w, x, y, z = q / np.linalg.norm(q)
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    T = np.eye(4)
    T[:3, :3] = R
    return T


class ReplicaParser:
    """reference dataset.py:19-45."""

    def __init__(self, input_folder):
        self.input_folder = input_folder
        self.color_paths = sorted(
            glob.glob(f"{input_folder}/results/frame*.jpg"))
        self.depth_paths = sorted(
            glob.glob(f"{input_folder}/results/depth*.png"))
        self.n_img = len(self.color_paths)
        self.poses = []
        with open(f"{input_folder}/traj.txt") as f:
            lines = f.readlines()
        for i in range(self.n_img):
            pose = np.array(list(map(float, lines[i].split()))).reshape(4, 4)
            self.poses.append(np.linalg.inv(pose))  # c2w -> w2c


class TUMParser:
    """reference dataset.py:48-122 (0.08 s association, 32 Hz downsample)."""

    def __init__(self, input_folder, frame_rate=32):
        self.input_folder = input_folder
        self._load(input_folder, frame_rate)
        self.n_img = len(self.color_paths)

    @staticmethod
    def _parse_list(filepath, skiprows=0):
        return np.loadtxt(filepath, delimiter=" ", dtype=np.str_,
                          skiprows=skiprows)

    @staticmethod
    def _associate(t_img, t_depth, t_pose, max_dt=0.08):
        assoc = []
        for i, t in enumerate(t_img):
            j = np.argmin(np.abs(t_depth - t))
            k = np.argmin(np.abs(t_pose - t))
            if (np.abs(t_depth[j] - t) < max_dt
                    and np.abs(t_pose[k] - t) < max_dt):
                assoc.append((i, j, k))
        return assoc

    def _load(self, datapath, frame_rate):
        if os.path.isfile(os.path.join(datapath, "groundtruth.txt")):
            pose_list = os.path.join(datapath, "groundtruth.txt")
        else:
            pose_list = os.path.join(datapath, "pose.txt")
        image_data = self._parse_list(os.path.join(datapath, "rgb.txt"))
        depth_data = self._parse_list(os.path.join(datapath, "depth.txt"))
        pose_data = self._parse_list(pose_list, skiprows=1)
        pose_vecs = pose_data[:, 0:].astype(np.float64)

        t_img = image_data[:, 0].astype(np.float64)
        t_depth = depth_data[:, 0].astype(np.float64)
        t_pose = pose_data[:, 0].astype(np.float64)
        assoc = self._associate(t_img, t_depth, t_pose)

        indices = [0]
        for i in range(1, len(assoc)):
            t0 = t_img[assoc[indices[-1]][0]]
            t1 = t_img[assoc[i][0]]
            if t1 - t0 > 1.0 / frame_rate:
                indices.append(i)

        self.color_paths, self.depth_paths, self.poses = [], [], []
        for ix in indices:
            i, j, k = assoc[ix]
            self.color_paths.append(os.path.join(datapath, image_data[i, 1]))
            self.depth_paths.append(os.path.join(datapath, depth_data[j, 1]))
            quat_xyzw = pose_vecs[k][4:]
            trans = pose_vecs[k][1:4]
            T = _quat_matrix_wxyz(np.roll(quat_xyzw, 1))
            T[:3, 3] = trans
            self.poses.append(np.linalg.inv(T))


class EuRoCParser:
    """reference dataset.py:125-190 (cam0 extrinsic chain)."""

    T_i_c0 = np.array([
        [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
        [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
        [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
        [0.0, 0.0, 0.0, 1.0],
    ])

    def __init__(self, input_folder, start_idx=0):
        self.input_folder = input_folder
        self.color_paths = sorted(
            glob.glob(f"{input_folder}/mav0/cam0/data/*.png"))[start_idx:]
        self.color_paths_r = sorted(
            glob.glob(f"{input_folder}/mav0/cam1/data/*.png"))[start_idx:]
        self.n_img = len(self.color_paths)
        self._load_poses(
            f"{input_folder}/mav0/state_groundtruth_estimate0/data.csv")

    def _load_poses(self, path):
        with open(path) as f:
            reader = csv.reader(f)
            next(reader)
            data = np.array([list(map(float, row)) for row in reader])
        pose_ts = data[:, 0]
        self.poses = []
        for i in range(self.n_img):
            color_ts = float(
                os.path.basename(self.color_paths[i]).split(".")[0])
            k = np.argmin(np.abs(pose_ts - color_ts))
            trans = data[k, 1:4]
            quat_wxyz = data[k, 4:8]
            # (reference shuffles wxyz->xyzw->roll back; net effect: wxyz)
            T_w_i = _quat_matrix_wxyz(quat_wxyz)
            T_w_i[:3, 3] = trans
            T_w_c = T_w_i @ self.T_i_c0
            self.poses.append(np.linalg.inv(T_w_c))


class BaseDataset:
    # frame IO may be loaded ahead on a host thread (frontend lookahead);
    # live-capture datasets override: prefetching would consume sensor
    # frames ahead of the tracking clock
    prefetchable = True

    def __init__(self, config: dict):
        self.config = config
        self.num_imgs = 999999

    def __len__(self):
        return self.num_imgs

    def __getitem__(self, idx):
        raise NotImplementedError

    def raw_frame(self, idx):
        """Compact-upload path: the integer source data of a frame, for
        h2d transfer in its native width with on-device dequantization.

        Returns (rgb_u8 (H, W, 3) uint8, depth_u16 (H, W) uint16 or
        None, depth_scale float, w2c pose) — dequantized frame must equal
        ``__getitem__``:  image = transpose(rgb_u8)/255,
        depth = depth_u16/depth_scale. Returns None when the dataset
        cannot provide integer-exact frames (the caller falls back to
        the float path).

        The source files are u8 PNG/JPEG and u16 depth anyway: shipping
        the native integers is ~3.2x fewer bytes than f32 frames, with
        bit-identical dequantized values."""
        return None


class MonocularDataset(BaseDataset):
    """reference dataset.py:209-278."""

    def __init__(self, config):
        super().__init__(config)
        calib = config["Dataset"]["Calibration"]
        self.fx = calib["fx"]
        self.fy = calib["fy"]
        self.cx = calib["cx"]
        self.cy = calib["cy"]
        self.width = calib["width"]
        self.height = calib["height"]
        self.fovx = focal2fov(self.fx, self.width)
        self.fovy = focal2fov(self.fy, self.height)
        self.K = np.array([[self.fx, 0, self.cx], [0, self.fy, self.cy],
                           [0, 0, 1.0]])
        self.disorted = calib.get("distorted", False)
        if self.disorted:
            cv2 = _cv2("undistortion")
            self.dist_coeffs = np.array(
                [calib["k1"], calib["k2"], calib["p1"], calib["p2"],
                 calib["k3"]])
            self.map1x, self.map1y = cv2.initUndistortRectifyMap(
                self.K, self.dist_coeffs, np.eye(3), self.K,
                (self.width, self.height), cv2.CV_32FC1)
        self.has_depth = "depth_scale" in calib
        self.depth_scale = calib.get("depth_scale")
        self.color_paths = []
        self.depth_paths = []
        self.poses = []

    def __getitem__(self, idx):
        Image = _pil_image()
        image = np.array(Image.open(self.color_paths[idx]))
        depth = None
        if self.disorted:
            cv2 = _cv2("undistortion")
            image = cv2.remap(image, self.map1x, self.map1y, cv2.INTER_LINEAR)
        if self.has_depth:
            depth = (np.array(Image.open(self.depth_paths[idx]))
                     / self.depth_scale).astype(np.float32)
        image = np.clip(image / 255.0, 0.0, 1.0).astype(np.float32)
        image = image.transpose(2, 0, 1)
        return image, depth, self.poses[idx]

    def raw_frame(self, idx):
        """Native-width frame for compact h2d upload (see BaseDataset).
        PNG/JPEG decode + undistortion stay in uint8 (cv2.remap
        interpolates in the source dtype); depth stays the on-disk
        uint16. Falls back (None) on unexpected channel counts/dtypes."""
        Image = _pil_image()
        image = np.asarray(Image.open(self.color_paths[idx]))
        if image.dtype != np.uint8 or image.ndim != 3 \
                or image.shape[2] != 3:
            return None
        if self.disorted:
            cv2 = _cv2("undistortion")
            image = cv2.remap(image, self.map1x, self.map1y,
                              cv2.INTER_LINEAR)
        depth = None
        if self.has_depth:
            depth = np.asarray(Image.open(self.depth_paths[idx]))
            if depth.dtype != np.uint16:
                return None
        return image, depth, float(self.depth_scale or 1.0), \
            self.poses[idx]


class StereoDataset(BaseDataset):
    """reference dataset.py:281-393 (rectify + SGBM depth)."""

    def __init__(self, config):
        super().__init__(config)
        cv2 = _cv2("stereo")
        calib = config["Dataset"]["Calibration"]
        self.width = calib["width"]
        self.height = calib["height"]
        cam0raw, cam0opt = calib["cam0"]["raw"], calib["cam0"]["opt"]
        cam1raw, cam1opt = calib["cam1"]["raw"], calib["cam1"]["opt"]
        self.fx, self.fy = cam0opt["fx"], cam0opt["fy"]
        self.cx, self.cy = cam0opt["cx"], cam0opt["cy"]
        self.fovx = focal2fov(self.fx, self.width)
        self.fovy = focal2fov(self.fy, self.height)
        self.K = np.array([[self.fx, 0, self.cx], [0, self.fy, self.cy],
                           [0, 0, 1.0]])
        K_raw = np.array([[cam0raw["fx"], 0, cam0raw["cx"]],
                          [0, cam0raw["fy"], cam0raw["cy"]], [0, 0, 1.0]])
        K_raw_r = np.array([[cam1raw["fx"], 0, cam1raw["cx"]],
                            [0, cam1raw["fy"], cam1raw["cy"]], [0, 0, 1.0]])
        K_r = np.array([[cam1opt["fx"], 0, cam1opt["cx"]],
                        [0, cam1opt["fy"], cam1opt["cy"]], [0, 0, 1.0]])
        Rmat = np.array(calib["cam0"]["R"]["data"]).reshape(3, 3)
        Rmat_r = np.array(calib["cam1"]["R"]["data"]).reshape(3, 3)
        d0 = np.array([cam0raw["k1"], cam0raw["k2"], cam0raw["p1"],
                       cam0raw["p2"], cam0raw["k3"]])
        d1 = np.array([cam1raw["k1"], cam1raw["k2"], cam1raw["p1"],
                       cam1raw["p2"], cam1raw["k3"]])
        self.map1x, self.map1y = cv2.initUndistortRectifyMap(
            K_raw, d0, Rmat, self.K, (self.width, self.height), cv2.CV_32FC1)
        self.map1x_r, self.map1y_r = cv2.initUndistortRectifyMap(
            K_raw_r, d1, Rmat_r, K_r, (self.width, self.height),
            cv2.CV_32FC1)
        self.has_depth = True
        self.color_paths = []
        self.color_paths_r = []
        self.poses = []

    def __getitem__(self, idx):
        cv2 = _cv2("stereo")
        image = cv2.imread(self.color_paths[idx], 0)
        image_r = cv2.imread(self.color_paths_r[idx], 0)
        image = cv2.remap(image, self.map1x, self.map1y, cv2.INTER_LINEAR)
        image_r = cv2.remap(image_r, self.map1x_r, self.map1y_r,
                            cv2.INTER_LINEAR)
        stereo = cv2.StereoSGBM_create(
            minDisparity=0, numDisparities=64, blockSize=20)
        stereo.setUniquenessRatio(40)
        disparity = stereo.compute(image, image_r) / 16.0
        invalid = disparity <= 0
        # baseline * fx (ORB-SLAM2 EuRoC constant, reference
        # dataset.py:376-383 — which maps invalid disparity through a
        # 1e10 sentinel, leaving ~5e-9 positive depths; zero explicitly)
        depth = 47.90639384423901 / np.where(invalid, 1.0, disparity)
        depth[invalid] = 0
        image = cv2.cvtColor(image, cv2.COLOR_GRAY2RGB)
        image = np.clip(image / 255.0, 0, 1).astype(np.float32)
        return image.transpose(2, 0, 1), depth.astype(np.float32), \
            self.poses[idx]


class TUMDataset(MonocularDataset):
    def __init__(self, config):
        super().__init__(config)
        parser = TUMParser(config["Dataset"]["dataset_path"])
        self.num_imgs = parser.n_img
        self.color_paths = parser.color_paths
        self.depth_paths = parser.depth_paths
        self.poses = parser.poses


class ReplicaDataset(MonocularDataset):
    def __init__(self, config):
        super().__init__(config)
        parser = ReplicaParser(config["Dataset"]["dataset_path"])
        self.num_imgs = parser.n_img
        self.color_paths = parser.color_paths
        self.depth_paths = parser.depth_paths
        self.poses = parser.poses


class EurocDataset(StereoDataset):
    def __init__(self, config):
        super().__init__(config)
        parser = EuRoCParser(config["Dataset"]["dataset_path"],
                             start_idx=config["Dataset"].get("start_idx", 0))
        self.num_imgs = parser.n_img
        self.color_paths = parser.color_paths
        self.color_paths_r = parser.color_paths_r
        self.poses = parser.poses


class SyntheticDataset(MonocularDataset):
    """Procedural RGB-D dataset for tests and benchmarks: an analytic scene
    raytraced on the host, a textured plane or a z-buffered room of
    textured rectangles. Deterministic."""

    def __init__(self, config):
        super().__init__(config)
        self.num_imgs = config["Dataset"].get("n_frames", 20)
        seed = config["Dataset"].get("seed", 0)
        # motion_scale=1.0 sweeps 0.2m over the trajectory; real 30Hz
        # sequences move ~millimetres per frame, so tests set a scale that
        # keeps per-frame motion inside a direct tracker's basin
        scale = config["Dataset"].get("motion_scale", 1.0)
        # "plane": the original single textured wall (tests). "room": a
        # z-buffered box interior with multi-scale texture and a 6-DoF
        # trajectory — full geometric constraint for cm-grade ATE work.
        self.scene = config["Dataset"].get("scene", "plane")
        rng = np.random.default_rng(seed)
        self.freqs = rng.uniform(0.5, 3.0, size=(3, 2))
        self.phases = rng.uniform(0, 2 * np.pi, size=3)
        # room texture bank: world-space sinusoids from coarse (2 rad/m)
        # to fine (~60 rad/m, ~10 cm wavelength)
        ww = rng.normal(size=(10, 3))
        ww *= (np.geomspace(2.0, 60.0, 10) /
               np.linalg.norm(ww, axis=1))[:, None]
        self.tex_w = ww
        self.tex_phase = rng.uniform(0, 2 * np.pi, size=(10, 3))
        self.tex_amp = rng.uniform(0.03, 0.1, size=(10, 3)) * \
            np.geomspace(1.0, 0.5, 10)[:, None]
        # room geometry: rect list (origin, u, v) — walls, floor, ceiling,
        # two boxes; normal faces from the winding (z-buffer picks nearest)
        self.rects = [
            ((-4.0, -2.5, 7.0), (8.0, 0, 0), (0, 5.0, 0)),    # back wall
            ((-4.0, -2.5, -1.0), (0, 0, 8.0), (0, 5.0, 0)),   # left wall
            ((4.0, -2.5, -1.0), (0, 0, 8.0), (0, 5.0, 0)),    # right wall
            ((-4.0, 2.5, -1.0), (8.0, 0, 0), (0, 0, 8.0)),    # floor
            ((-4.0, -2.5, -1.0), (8.0, 0, 0), (0, 0, 8.0)),   # ceiling
            ((-2.5, 1.0, 4.0), (1.5, 0, 0), (0, 1.5, 0)),     # box front
            ((-2.5, 1.0, 4.0), (1.5, 0, 0), (0, 0, 1.0)),     # box top
            ((1.0, -0.5, 5.0), (2.0, 0, 0), (0, 3.0, 0)),     # screen
        ]
        self.poses = []
        for i in range(self.num_imgs):
            t = i / max(self.num_imgs - 1, 1)
            if self.scene == "room":
                # smooth 6-DoF sweep: ~0.2*scale m translation arc plus a
                # few degrees of yaw/pitch over the sequence
                c2w = np.eye(4)
                yaw = scale * 0.10 * np.sin(2 * np.pi * t)
                pitch = scale * 0.05 * np.sin(4 * np.pi * t + 1.0)
                cy_, sy_ = np.cos(yaw), np.sin(yaw)
                cp_, sp_ = np.cos(pitch), np.sin(pitch)
                Ry = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
                Rx = np.array([[1, 0, 0], [0, cp_, -sp_], [0, sp_, cp_]])
                c2w[:3, :3] = Ry @ Rx
                c2w[:3, 3] = [scale * 0.25 * np.sin(2 * np.pi * t),
                              scale * 0.10 * np.cos(2 * np.pi * t),
                              scale * 0.30 * t]
                w2c = np.linalg.inv(c2w)
            else:
                w2c = np.eye(4)
                w2c[0, 3] = scale * 0.2 * np.sin(2 * np.pi * t)
                w2c[1, 3] = scale * 0.1 * np.cos(2 * np.pi * t)
                w2c[2, 3] = scale * 0.1 * t
            self.poses.append(w2c)
        self.has_depth = True
        # the host raytrace is far slower than decoding a real dataset's
        # files and the scene is deterministic, so rendered frames are
        # memoized (24 frames at 1216x672 ~ 380 MB; disable with
        # Dataset.cache_frames: false)
        self._cache_frames = config["Dataset"].get("cache_frames", True)
        self._frame_cache = {}

    def _texture(self, pts):
        """(H, W, 3) multi-scale world-space texture for the room scene."""
        img = np.full(pts.shape[:2] + (3,), 0.45, np.float32)
        for k in range(self.tex_w.shape[0]):
            ph = pts @ self.tex_w[k]
            img += (self.tex_amp[k][None, None]
                    * np.sin(ph[..., None] + self.tex_phase[k][None, None]))
        return np.clip(img, 0.02, 0.98)

    def _render_room(self, w2c, dirs_cam=None):
        """``dirs_cam``: optional (H, W, 3) per-pixel camera-frame ray
        directions (z=1 plane). The default is the ideal pinhole grid;
        the TUM-tree e2e fixture passes undistorted rays to synthesize
        frames that round-trip through the loader's cv2 undistortion
        (tests/test_driver_tum.py)."""
        c2w = np.linalg.inv(w2c)
        H, W = self.height, self.width
        if dirs_cam is None:
            ys, xs = np.mgrid[0:H, 0:W]
            dx = (xs + 0.5 - self.cx) / self.fx
            dy = (ys + 0.5 - self.cy) / self.fy
            dirs_cam = np.stack([dx, dy, np.ones_like(dx)], -1)
        dirs_w = dirs_cam @ c2w[:3, :3].T
        org_w = c2w[:3, 3]
        best_t = np.full((H, W), np.inf, np.float32)
        best_pt = np.zeros((H, W, 3), np.float32)
        for (o, u, v) in self.rects:
            o = np.asarray(o, np.float64)
            u = np.asarray(u, np.float64)
            v = np.asarray(v, np.float64)
            n = np.cross(u, v)
            denom = dirs_w @ n
            tt = ((o - org_w) @ n) / np.where(np.abs(denom) < 1e-9,
                                              np.inf, denom)
            pts = org_w + tt[..., None] * dirs_w
            rel = pts - o
            a = (rel @ u) / (u @ u)
            b = (rel @ v) / (v @ v)
            hit = ((tt > 0.05) & (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1)
                   & (tt < best_t))
            best_t = np.where(hit, tt, best_t)
            best_pt = np.where(hit[..., None], pts, best_pt)
        img = self._texture(best_pt).transpose(2, 0, 1).astype(np.float32)
        covered = np.isfinite(best_t)
        img = img * covered[None]
        z_cam = ((best_pt - org_w) @ w2c[:3, :3].T)[..., 2]
        depth = np.where(covered, z_cam, 0.0).astype(np.float32)
        return img, depth

    # raw_frame quantization: 0.2 mm depth quantum, 13.1 m range
    _RAW_DEPTH_SCALE = 5000.0

    def raw_frame(self, idx):
        """Compact-upload path for the synthetic scene. Unlike the
        file-backed datasets (whose source data IS u8/u16, so the raw
        path is exact), the synthetic render is f32 — this quantizes to
        u8 RGB (1/255 quantum) and u16 depth at 5000 counts/m (0.2 mm
        quantum, the TUM encoding), both far below the scene's tracking
        noise floor. Disable with Training.compact_upload: false for
        bit-exact f32 frames."""
        img, depth, pose = self[idx]
        rgb = np.clip(np.round(img.transpose(1, 2, 0) * 255.0),
                      0, 255).astype(np.uint8)
        d16 = None
        if depth is not None:
            d16 = np.clip(np.round(depth * self._RAW_DEPTH_SCALE),
                          0, 65535).astype(np.uint16)
        return rgb, d16, self._RAW_DEPTH_SCALE, pose

    def __getitem__(self, idx):
        w2c = self.poses[idx]
        if self.scene == "room":
            if self._cache_frames and idx in self._frame_cache:
                img, depth = self._frame_cache[idx]
            else:
                img, depth = self._render_room(w2c)
                if self._cache_frames:
                    self._frame_cache[idx] = (img, depth)
            return img, depth, w2c
        c2w = np.linalg.inv(w2c)
        H, W = self.height, self.width
        ys, xs = np.mgrid[0:H, 0:W]
        # rays in cam frame through pixel centers (pinhole)
        dx = (xs + 0.5 - self.cx) / self.fx
        dy = (ys + 0.5 - self.cy) / self.fy
        dirs_cam = np.stack([dx, dy, np.ones_like(dx)], -1)
        dirs_w = dirs_cam @ c2w[:3, :3].T
        org_w = c2w[:3, 3]
        # plane z_w = 3.0
        tt = (3.0 - org_w[2]) / np.maximum(dirs_w[..., 2], 1e-6)
        pts = org_w + tt[..., None] * dirs_w
        img = np.stack([
            0.5 + 0.45 * np.sin(self.freqs[c, 0] * pts[..., 0] * 4
                                + self.freqs[c, 1] * pts[..., 1] * 4
                                + self.phases[c])
            for c in range(3)], axis=0).astype(np.float32)
        depth_cam = (pts - c2w[:3, 3]) @ w2c[:3, :3].T  # world->cam rot
        depth = np.maximum(depth_cam[..., 2], 0).astype(np.float32)
        return np.clip(img, 0, 1), depth, w2c


class SyntheticStereoDataset(SyntheticDataset):
    """Stereo rig over the synthetic room: renders a LEFT and a RIGHT
    view separated by a known ``baseline`` along the camera x-axis and
    recovers depth with the SAME SGBM pipeline the EuRoC stereo path
    uses (StereoDataset.__getitem__ / reference dataset.py:376-383:
    ``depth = fx*baseline / disparity``). This is the stereo SLAM mode's
    end-to-end testbed in the zero-egress environment — the full chain
    (rectified pair -> SGBM disparity -> depth -> tracking/mapping) runs
    with ground-truth poses available for ATE.

    The rig is born rectified (both cameras share intrinsics, offset is
    pure x translation), so no undistortion maps are needed — that leg
    is exercised by the EuRoC parser tests
    (tests/test_datasets_parsers.py)."""

    def __init__(self, config):
        super().__init__(config)
        _cv2("stereo")
        ds = config["Dataset"]
        if self.scene != "room":
            raise ValueError(
                "synthetic stereo needs the z-buffered room scene")
        self.baseline = float(ds.get("baseline", 0.3))
        self.num_disparities = int(ds.get("num_disparities", 32))
        self.sgbm_block = int(ds.get("sgbm_block", 7))

    def _right_w2c(self, w2c):
        """w2c of the right camera: p_camR = p_camL - (b, 0, 0)."""
        off = np.eye(4)
        off[0, 3] = -self.baseline
        return off @ w2c

    def __getitem__(self, idx):
        w2c = self.poses[idx]
        if self._cache_frames and idx in self._frame_cache:
            img, depth = self._frame_cache[idx]
            return img, depth, w2c
        cv2 = _cv2("stereo")
        img_l, _ = self._render_pair(w2c)
        img_r, _ = self._render_pair(self._right_w2c(w2c))
        to_u8 = lambda im: np.clip(np.round(  # noqa: E731
            im.mean(axis=0) * 255.0), 0, 255).astype(np.uint8)
        gray_l, gray_r = to_u8(img_l), to_u8(img_r)
        stereo = cv2.StereoSGBM_create(
            minDisparity=0, numDisparities=self.num_disparities,
            blockSize=self.sgbm_block)
        stereo.setUniquenessRatio(40)
        disparity = stereo.compute(gray_l, gray_r) / 16.0
        invalid = disparity <= 0
        depth = (self.fx * self.baseline) / np.where(invalid, 1.0, disparity)
        # invalid-disparity pixels get depth 0 EXPLICITLY: the 1e10
        # sentinel division leaves tiny positive depths (~2e-8) that pass
        # seeding's depth>0 validity and unproject gaussians at the
        # camera center
        depth[invalid] = 0.0
        depth = depth.astype(np.float32)
        if self._cache_frames:
            self._frame_cache[idx] = (img_l, depth)
        return img_l, depth, w2c

    def _render_pair(self, w2c):
        return self._render_room(w2c)

    def raw_frame(self, idx):
        img, depth, pose = self[idx]
        rgb = np.clip(np.round(img.transpose(1, 2, 0) * 255.0),
                      0, 255).astype(np.uint8)
        d16 = np.clip(np.round(depth * self._RAW_DEPTH_SCALE),
                      0, 65535).astype(np.uint16)
        return rgb, d16, self._RAW_DEPTH_SCALE, pose


class RealsenseDataset(BaseDataset):
    """Live Intel RealSense capture (reference dataset.py:429-519).

    Streams 1280x720 color (+ aligned depth when sensor_type == 'depth'),
    reads intrinsics/distortion from the device, locks auto-exposure /
    auto-white-balance (exposure 200, like the reference), undistorts via
    cv2 rectify maps and returns (image[3HW float], depth|None, eye-pose).

    ``pipeline_factory`` injects a fake rs-like pipeline for tests; the
    default imports pyrealsense2 (hardware required).
    """

    prefetchable = False   # sensor frames must not be consumed ahead

    def __init__(self, config, pipeline_factory=None):
        super().__init__(config)
        sensor_type = config["Dataset"].get("sensor_type", "monocular")
        self.has_depth = sensor_type == "depth"
        self.num_imgs = config["Dataset"].get(
            "n_frames", 1_000_000)        # live stream: effectively endless
        self.w, self.h = 1280, 720

        if pipeline_factory is None:
            import pyrealsense2 as rs   # hardware-gated import

            self.rs = rs
            self.pipeline = rs.pipeline()
            rs_config = rs.config()
            rs_config.enable_stream(rs.stream.color, self.w, self.h,
                                    rs.format.bgr8, 30)
            if self.has_depth:
                rs_config.enable_stream(rs.stream.depth)
            self.profile = self.pipeline.start(rs_config)
            if self.has_depth:
                self.align = rs.align(rs.stream.color)
                depth_sensor = self.profile.get_device() \
                                           .first_depth_sensor()
                self.depth_scale = depth_sensor.get_depth_scale()
            rgb_sensor = self.profile.get_device().query_sensors()[1]
            rgb_sensor.set_option(rs.option.enable_auto_exposure, False)
            rgb_sensor.set_option(rs.option.enable_auto_white_balance,
                                  False)
            rgb_sensor.set_option(rs.option.exposure, 200)
            intr = rs.video_stream_profile(
                self.profile.get_stream(rs.stream.color)).get_intrinsics()
            self.fx, self.fy = intr.fx, intr.fy
            self.cx, self.cy = intr.ppx, intr.ppy
            self.width, self.height = intr.width, intr.height
            self.dist_coeffs = np.asarray(intr.coeffs)
        else:
            # injected fake: (get_frames, intrinsics_dict)
            self.pipeline, intr = pipeline_factory()
            self.fx, self.fy = intr["fx"], intr["fy"]
            self.cx, self.cy = intr["cx"], intr["cy"]
            self.width, self.height = intr["width"], intr["height"]
            self.dist_coeffs = np.asarray(intr.get("coeffs", np.zeros(5)))
            self.depth_scale = intr.get("depth_scale", 1.0)

        self.fovx = focal2fov(self.fx, self.width)
        self.fovy = focal2fov(self.fy, self.height)
        self.K = np.array([[self.fx, 0, self.cx], [0, self.fy, self.cy],
                           [0, 0, 1.0]])
        self.disorted = bool(np.any(self.dist_coeffs != 0))
        cv2 = _cv2_or_none()
        if self.disorted and cv2 is not None:
            self.map1x, self.map1y = cv2.initUndistortRectifyMap(
                self.K, self.dist_coeffs, np.eye(3), self.K,
                (self.width, self.height), cv2.CV_32FC1)

    def __len__(self):
        return self.num_imgs

    def __getitem__(self, idx):
        pose = np.eye(4, dtype=np.float32)   # live: no gt trajectory
        image, depth = self.pipeline.get_frames(self.has_depth)
        if depth is not None:
            depth = np.asarray(depth, np.float32) * self.depth_scale
            depth[depth < 0] = 0
            depth = np.nan_to_num(depth, nan=1000.0)
        cv2 = _cv2_or_none()
        if self.disorted and cv2 is not None:
            image = cv2.remap(image, self.map1x, self.map1y,
                              cv2.INTER_LINEAR)
        img = np.clip(np.asarray(image, np.float32) / 255.0, 0, 1)
        return np.transpose(img, (2, 0, 1)), depth, pose


def load_dataset(config: dict):
    t = config["Dataset"]["type"]
    if t == "tum":
        return TUMDataset(config)
    if t == "replica":
        return ReplicaDataset(config)
    if t == "euroc":
        return EurocDataset(config)
    if t == "synthetic":
        if config["Dataset"].get("sensor_type") == "stereo":
            return SyntheticStereoDataset(config)
        return SyntheticDataset(config)
    if t == "realsense":
        return RealsenseDataset(config)
    raise ValueError(f"Unknown dataset type {t}")
