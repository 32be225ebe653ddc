"""Camera calibration registry for the viewpoints the planner and the
heatmaps render from.

The reference's measured per-robot/viewpoint camera_to_world extrinsics and
the intrinsics of its cameras (reference: src/utils/camera_calibration.py;
the reference's realsense matrix has fy in K[1,0], a row typo, stored here
with fy at K[1,1]), behind a registry: `register_camera` installs a runtime
calibration (e.g. from an AprilTag) over the measured one, and a viewpoint
with no measurement gets a look-at camera on the workspace. A copy of
`robot_aware_control_tpu/data/calibration.py`'s tables and registry.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def look_at(eye, target, up=(0, 0, 1.0)):
    """camera-to-world 4x4 (OpenCV convention: +z forward, +x right, +y down)."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    upv = np.asarray(up, np.float64)
    right = np.cross(fwd, upv)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = down
    c2w[:3, 2] = fwd
    c2w[:3, 3] = eye
    return c2w


def intrinsics(fx, fy, cx, cy):
    K = np.eye(3)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy
    return K


# intrinsics at native sensor resolutions (resized by consumers)
CAM_INTRINSICS: Dict[str, np.ndarray] = {
    # captured 640x480 images for locobot (intel realsense d435)
    "intel_realsense_d435": intrinsics(612.45, 612.56, 330.55, 248.61),
    # captured 320x240 images in robonet (logitech c420)
    "logitech_c420": intrinsics(320.75, 320.75, 160.0, 120.0),
}
CAM_RESOLUTION: Dict[str, tuple] = {
    "intel_realsense_d435": (640, 480),
    "logitech_c420": (320, 240),
}

# measured camera_to_world extrinsics per robot_viewpoint key
# (reference: src/utils/camera_calibration.py:6-168, verbatim incl. the
# inline hand-tuned offsets on locobot_modified/franka/wx250s rows)
_MEASURED_CAMERA_TO_WORLD = {
    "baxter_left_c0": [
        [0.05010049, 0.5098481, -0.85880432, 1.70268951],
        [0.99850135, -0.00660876, 0.05432662, 0.26953027],
        [0.02202269, -0.86023906, -0.50941512, 0.48536055],
    ],
    "baxter_right_c0": [
        [0.59474902, -0.48560866, 0.64066983, 0.00593267],
        [-0.80250365, -0.40577623, 0.4374169, -0.84046503],
        [0.04755516, -0.77429315, -0.63103774, 0.45875102],
    ],
    "sawyer_sudri0_c0": [
        [-0.01290487, 0.62117762, -0.78356355, 1.21061856],
        [1.0, 0.00660994, -0.01122798, 0.01680913],
        [-0.00179526, -0.78364193, -0.62121019, 0.47401633],
    ],
    "sawyer_sudri0_c1": [
        [0.9975901, 0.0691292, 0.00592799, 0.60620359],
        [0.04619134, -0.72546495, 0.68670734, -0.42756365],
        [0.05177208, -0.68477862, -0.72690982, 0.53600216],
    ],
    "sawyer_sudri0_c2": [
        [-0.35527701, 0.41521095, -0.8374832, 1.12403976],
        [0.9189123, -0.00914706, -0.39435582, 0.24057687],
        [-0.17140136, -0.90967917, -0.37829271, 0.29666432],
    ],
    "sawyer_sudri2_c0": [
        [-0.20352987, 0.64259509, -0.73867932, 1.17506129],
        [0.9567336, -0.02969794, -0.28944578, 0.19938629],
        [-0.20793369, -0.76563018, -0.6087479, 0.46536255],
    ],
    "sawyer_sudri2_c1": [
        [0.99706184, 0.07581474, 0.01094559, 0.55393717],
        [0.04626195, -0.7098712, 0.70281058, -0.4425706],
        [0.06105336, -0.70023925, -0.71129282, 0.52610051],
    ],
    "sawyer_sudri2_c2": [
        [-0.39771899, 0.36153698, -0.84327375, 1.14520489],
        [0.89713902, -0.03934587, -0.4399926, 0.30102312],
        [-0.19225293, -0.9315272, -0.30870033, 0.28974425],
    ],
    "sawyer_vestri_table2_c0": [
        [-0.01183555, 0.58241102, -0.8128083, 1.31055191],
        [0.99973558, -0.00913481, -0.02110293, 0.0089173],
        [-0.01971543, -0.81284313, -0.5821489, 0.50151772],
    ],
    "sawyer_vestri_table2_c1": [
        [0.99962747, 0.01402494, -0.02341411, 0.65820915],
        [0.0265253, -0.70128186, 0.71239046, -0.47751281],
        [-0.00642866, -0.71274614, -0.70139263, 0.56862831],
    ],
    "sawyer_vestri_table2_c2": [
        [-0.06536258, 0.43301436, -0.89901407, 1.24390769],
        [0.99785944, 0.02649836, -0.05978605, 0.0647729],
        [-0.00206582, -0.90099745, -0.43381947, 0.36955964],
    ],
    "widowx_widowx1_c0": [
        [-0.17251765, 0.5984481, -0.78236663, 0.37869496],
        [-0.98499368, -0.10885336, 0.13393427, -0.04712975],
        [-0.00501052, 0.79373221, 0.60824672, 0.15596613],
    ],
    "locobot_c0": [
        [0.10142061, 0.72632463, -0.67386291, 0.78975893],
        [0.98958408, -0.08242317, 0.06193354, -0.03911564],
        [-0.00928995, -0.68100839, -0.72849251, 0.64767807],
    ],
    "locobot_modified_c0": [
        [0.0452768, 0.73303716, -0.67868, 0.79116035],
        [0.99869241, -0.01707084, 0.04818772, -0.00249282 - 0.015],
        [0.02373775, -0.67997435, -0.73285156, 0.64026054 + 0.0125],
    ],
    "franka_c0": [
        [0.01309514, 0.71015083, -0.70392778, 1.13944446],
        [0.9995991, -0.02697114, -0.00861408, 0.05091183 - 0.01],
        [-0.02510303, -0.70353277, -0.71021932, 0.5631501 + 0.015],
    ],
    "wx250s_c0": [
        [0.05598868, 0.80338198, -0.592826, 0.82155341],
        [0.99834883, -0.0526833, 0.02289275, -0.018],
        [-0.01284041, -0.59312888, -0.80500513, 0.58407623],
    ],
    # kuka renders through the sawyer_sudri0_c0 rig (reference:
    # src/env/robotics/masks/kuka_mask_env.py:113-121 — same matrix)
    "kuka_c0": [
        [-0.01290487, 0.62117762, -0.78356355, 1.21061856],
        [1.0, 0.00660994, -0.01122798, 0.01680913],
        [-0.00179526, -0.78364193, -0.62121019, 0.47401633],
    ],
    # fetch viewpoint (reference: src/env/robotics/masks/
    # fetch_mask_env.py:171-185; that main skips the OpenCV->MuJoCo flip
    # and its XML ships no main_cam, so the reference fetch path cannot
    # actually render — we treat the matrix as OpenCV-convention
    # camera_to_world, which points the camera at the robot)
    "fetch_c0": [
        [-0.00715332, 0.65439626, -0.75611796, 1.13910297],
        [0.9996319, 0.02446862, 0.01171972, 0.34967541],
        [0.0261705, -0.7557558, -0.65433041, 0.28774818],
    ],
}
# locobot_c1..c3 share locobot_c0's rig (reference: camera_calibration.py:111-135)
for _i in (1, 2, 3):
    _MEASURED_CAMERA_TO_WORLD[f"locobot_c{_i}"] = _MEASURED_CAMERA_TO_WORLD[
        "locobot_c0"
    ]

_DEFAULT_WORKSPACE_CENTER = np.array([0.28, 0.0, 0.15])
CAMERA_TO_WORLD: Dict[str, np.ndarray] = {}
WORLD_TO_CAMERA: Dict[str, np.ndarray] = {}


def register_camera(key: str, camera_to_world: np.ndarray):
    c2w = np.eye(4)
    c2w[:3] = np.asarray(camera_to_world, np.float64)[:3]
    CAMERA_TO_WORLD[key] = c2w
    WORLD_TO_CAMERA[key] = np.linalg.inv(c2w)


def get_camera_to_world(key: str) -> np.ndarray:
    if key not in CAMERA_TO_WORLD:
        if key in _MEASURED_CAMERA_TO_WORLD:
            register_camera(key, np.array(_MEASURED_CAMERA_TO_WORLD[key]))
        else:
            register_camera(
                key, look_at([0.9, 0.0, 0.75], _DEFAULT_WORKSPACE_CENTER)
            )
    return CAMERA_TO_WORLD[key]


def get_world_to_camera(key: str) -> np.ndarray:
    get_camera_to_world(key)
    return WORLD_TO_CAMERA[key]


# seed the registry with the viewpoints the reference refers to by name
for _key in list(_MEASURED_CAMERA_TO_WORLD) + ["synthetic_c0"]:
    get_camera_to_world(_key)


def robot_camera_info(robot: str, viewpoint: str):
    """(world2cam, intrinsics K, native resolution) for a robot viewpoint
    (reference mapping: robonet_dataset.py:497-518)."""
    if robot == "locobot":
        key, cam = "locobot_c0", "intel_realsense_d435"
    elif robot in ("sawyer", "baxter", "widowx"):
        key, cam = f"{robot}_{viewpoint}", "logitech_c420"
    else:
        key, cam = f"{robot}_{viewpoint}", "intel_realsense_d435"
    return get_world_to_camera(key), CAM_INTRINSICS[cam], CAM_RESOLUTION[cam]
