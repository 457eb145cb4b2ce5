"""The solution apps in the port (``solutions/``) and the Annotator's
drawing they use (``utils/plotting.py``) against the JAX package.

The apps run on the same track sequences in both packages (ByteTrack over
seeded scenes of moving boxes, the rows x1 y1 x2 y2 id conf cls): counts,
class-wise counts, speeds, distances, heatmap accumulators and the workout
counter's reps, stages and angles are equal, and every annotated frame
equals JAX's PIL drawing bit for bit, with PIL's bitmap default font (set
for this module, as in ``tests/test_torch_sources.py``; with FreeType PIL's
own default is Aileron)."""

import numpy as np
import pytest
from PIL import ImageDraw, ImageFont

import yolov10_3d_tpu.solutions as jax_solutions
import yolov10_3d_torch.solutions as port_solutions
from _torch_threads import torch_threads  # noqa: F401  (autouse)
from yolov10_3d_tpu.utils.plotting import Annotator as JaxAnnotator
from yolov10_3d_torch.trackers import BYTETracker, byte_tracker
from yolov10_3d_torch.utils.plotting import Annotator

H, W = 240, 320
NAMES = {0: "person", 1: "car", 2: "bike"}


@pytest.fixture(scope="module", autouse=True)
def bitmap_font():
    old = ImageDraw.ImageDraw.font
    ImageDraw.ImageDraw.font = ImageFont.load_default_imagefont()
    yield
    ImageDraw.ImageDraw.font = old


def _tracks(seed: int = 0, n_frames: int = 24):
    """ByteTrack's rows over boxes crossing the frame in both directions,
    one frame of RGB noise each."""
    rng = np.random.default_rng(seed)
    byte_tracker.STrack._count = 0
    trk = BYTETracker()
    objs = [(rng.uniform(0, W - 60), rng.uniform(0, H - 60), rng.uniform(-12, 12),
             rng.uniform(-8, 8), int(rng.integers(0, 3))) for _ in range(6)]
    out = []
    for t in range(n_frames):
        boxes = np.array([[x + vx * t, y + vy * t, x + vx * t + 50, y + vy * t + 60]
                          for x, y, vx, vy, _ in objs])
        rows = trk.update(boxes + rng.normal(0, 0.5, boxes.shape), rng.uniform(0.6, 0.9, 6),
                          np.array([o[4] for o in objs]))
        out.append((rng.integers(0, 256, (H, W, 3), dtype=np.uint8), rows))
    return out


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_object_counter_matches_jax():
    """A counting line with trails, and a region moved mid-way: counts and
    frames equal."""
    seq = _tracks(3)
    for region, kw in (([(40, 120), (280, 120)], dict(draw_tracks=True)),
                       ([(60, 40), (260, 50), (250, 200), (70, 190)],
                        dict(view_in_counts=False, region_thickness=3, track_thickness=3))):
        a = jax_solutions.ObjectCounter(region, names=NAMES, **kw)
        b = port_solutions.ObjectCounter(region, names=NAMES, **kw)
        for t, (im, rows) in enumerate(seq):
            if t == 12:
                for c in (a, b):
                    c.move_region_point(0, (30.5, 100.25))
            _same(a.start_counting(im.copy(), rows), b.start_counting(im.copy(), rows))
            assert (a.in_count, a.out_count, dict(a.classwise)) == \
                (b.in_count, b.out_count, dict(b.classwise))
        assert a.in_count + a.out_count > 0
        assert b.region_centroid == a.region_centroid


def test_heatmap_matches_jax():
    """Circle and box footprints, with a counting region and a line: the
    accumulator, the counts and the blended, annotated frames equal."""
    seq = _tracks(2)
    cases = ((dict(shape_kind="circle", count_reg_pts=[(50, 50), (270, 60), (200, 200)])),
             (dict(shape_kind="rect", count_reg_pts=[(20, 130), (300, 110)],
                   view_out_counts=False, decay=0.95)),
             (dict(shape_kind="circle")))
    for kw in cases:
        a, b = jax_solutions.Heatmap((H, W), **kw), port_solutions.Heatmap((H, W), **kw)
        for im, rows in seq:
            _same(a.generate_heatmap(im.copy(), rows), b.generate_heatmap(im.copy(), rows))
            _same(a.acc, b.acc)
            assert (a.in_counts, a.out_counts) == (b.in_counts, b.out_counts)
    np.testing.assert_array_equal(port_solutions.heatmap.jet_colormap(np.linspace(0, 1, 99)),
                                  jax_solutions.heatmap.jet_colormap(np.linspace(0, 1, 99)))


def test_speed_and_distance_match_jax():
    """Speeds of the sliding window and of the region crossing (the clock
    given), distances between all pairs and between two selected tracks:
    values and frames equal."""
    seq = _tracks(4)
    kw = dict(fps=30.0, pixels_per_meter=8.0, reg_pts=[(10, 100), (310, 100)], names=NAMES,
              spdl_dist_thresh=40.0)
    a, b = jax_solutions.SpeedEstimator(**kw), port_solutions.SpeedEstimator(**kw)
    for t, (im, rows) in enumerate(seq):
        assert a.update(rows) == b.update(rows)
        _same(a.estimate_speed(im.copy(), rows, t=0.1 * t), b.estimate_speed(im.copy(), rows,
                                                                             t=0.1 * t))
        assert a.dist_data == b.dist_data
    assert b.dist_data
    a = jax_solutions.DistanceCalculator(pixels_per_meter=5.0, names=NAMES, line_thickness=2)
    b = port_solutions.DistanceCalculator(pixels_per_meter=5.0, names=NAMES, line_thickness=2)
    for t, (im, rows) in enumerate(seq):
        assert a.update(rows) == b.update(rows)
        if t in (3, 4, 9) and len(rows):
            r = rows[t % len(rows)]
            x, y = (r[0] + r[2]) / 2, (r[1] + r[3]) / 2
            assert a.select(x, y) == b.select(x, y)
        if t == 15:
            a.deselect()
            b.deselect()
        _same(a.start_process(im.copy(), rows), b.start_process(im.copy(), rows))
    assert a.calculate_distance((3, 4), (30, 40)) == b.calculate_distance((3, 4), (30, 40))


def test_ai_gym_matches_jax():
    """Each pose type over keypoint sequences of two people bending and
    straightening (with a low-confidence point and one on the border):
    reps, stages, angles and frames equal."""
    rng = np.random.default_rng(4)
    t = np.linspace(0, 4 * np.pi, 40)
    for pose in ("pushup", "pullup", "abworkout", "squat"):
        a = jax_solutions.AIGym([5, 7, 9], pose_type=pose, line_thickness=2)
        b = port_solutions.AIGym([5, 7, 9], pose_type=pose, line_thickness=2)
        for i, phase in enumerate(t):
            kpts = rng.uniform(20, 220, (2, 17, 3))
            kpts[:, :, 2] = rng.uniform(0.3, 1.0, (2, 17))
            for p in range(2):  # the angle at 7 swings between about 40 and 180 degrees
                ang = np.radians(110 + 70 * np.cos(phase + p))
                kpts[p, 7, :2] = (120 + 40 * p, 120)
                kpts[p, 5, :2] = kpts[p, 7, :2] + (60, 0)
                kpts[p, 9, :2] = kpts[p, 7, :2] + 60 * np.array([np.cos(ang), np.sin(ang)])
            kpts[1, 9, 2] = 0.1 if i % 5 == 0 else kpts[1, 9, 2]
            kpts[0, 5, 0] = 0.0 if i % 7 == 0 else kpts[0, 5, 0]
            im = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
            _same(a.start_counting(im.copy(), kpts, frame_count=i + 1),
                  b.start_counting(im.copy(), kpts, frame_count=i + 1))
            assert (a.count, a.stage) == (b.count, b.stage)
            np.testing.assert_array_equal(b.angle, a.angle)
        assert sum(b.count) > 0


def test_annotator_draws_as_pil():
    """Lines of every width (PIL's wide-line quadrilaterals), polylines,
    circles filled and outlined, regions, trails, banners and the gym and
    distance readouts over random inputs: bit for bit PIL."""
    rng = np.random.default_rng(5)
    for t in range(120):
        img = rng.integers(0, 256, (90, 120, 3), dtype=np.uint8)
        lw = int(rng.integers(1, 6))
        anns = JaxAnnotator(img.copy(), lw), Annotator(img.copy(), lw)
        draw = np.random.default_rng(t)
        pts = [tuple(int(v) for v in draw.integers(-20, 140, 2))
               for _ in range(int(draw.integers(2, 6)))]
        widths = [int(v) for v in draw.integers(1, 9, 4)]
        radius, fill = int(draw.integers(0, 14)), bool(t % 2)
        for ann in anns:
            ann.draw_region(pts, (255, 0, 255), widths[0])
            ann.draw_centroid_and_tracks(pts, (0, 255, 0), widths[1] % 4 + 1)
            ann.circle(pts[0], radius, (1, 2, 3), fill=fill)
            ann.line(pts[0], pts[-1], (9, 9, 9), widths[2])
            ann.line(pts[1], pts[0], (90, 9, 9))
            ann.count_labels(f"In Count : {t} OutCount : {3 * t}")
            ann.plot_angle_and_count_and_stage(123.456, 3, "up", pts[1])
            ann.plot_distance_and_line(1.23, 1230.0, (pts[0], pts[1]))
            ann.box_label([10, 10, 50, 60], "7:person", (200, 10, 10))
        _same(anns[0].result(), anns[1].result())
    assert Annotator.estimate_pose_angle((0, 1), (0, 0), (1, 0)) == 90.0
