"""The port's camera motions (``Camera.basis`` / ``dollied`` / ``panned`` /
``flown`` / ``walked`` / ``looked``) and ``Manipulator`` against the JAX
package's, on the cases of tests/test_camera.py:57-178 and drives of every
mode.  Both are host numpy doing the same float64 arithmetic, so every
resulting state is bit-equal; the invariants of tests/test_camera.py are
checked on the port as well.
"""

import numpy as np
import pytest

from royaltracer_dx_tpu import camera as jcam

from royaltracer_dx_tpu_torch import camera as tcam


def both(fn):
    """fn(camera module) run on both packages."""
    return fn(tcam), fn(jcam)


def cam_state(c):
    return np.array([c.eye, c.center, c.up], np.float64)


def man_state(m):
    return np.concatenate([m.pos, m.int, m.up, m.mouse])


# ------------------------------ Camera -----------------------------------

CAMERA_MOVES = {
    "basis": lambda c: np.concatenate(c.basis()),
    "orbited": lambda c: cam_state(c.orbited(0.1, 0.05)),
    "orbited-pole": lambda c: cam_state(c.orbited(0.0, 0.24)),
    "dollied": lambda c: cam_state(c.dollied(0.5)),
    "panned": lambda c: cam_state(c.panned(0.1, -0.07)),
    "flown": lambda c: cam_state(c.flown(0.3, 0.2, -0.1)),
    "walked": lambda c: cam_state(c.walked(0.4, -0.3)),
    "looked": lambda c: cam_state(c.looked(0.05, 0.03)),
    "looked-pole": lambda c: cam_state(c.looked(0.0, 0.3)),
}


@pytest.mark.parametrize("move", sorted(CAMERA_MOVES))
def test_camera_moves_match(move):
    t, j = both(lambda m: CAMERA_MOVES[move](
        m.Camera(eye=(-1.5, 1.5, 3.5), center=(0.0, 1.0, 0.0))))
    np.testing.assert_array_equal(t, j)


def test_camera_move_invariants():
    """tests/test_camera.py:57-79 on the port: orbit keeps the distance,
    dolly scales it, pan moves eye and center together, fly keeps the
    look direction, walk keeps the height."""
    cam = tcam.Camera()
    d0 = np.linalg.norm(np.subtract(cam.eye, cam.center))
    c2 = cam.orbited(0.1, 0.05)
    assert np.isclose(np.linalg.norm(np.subtract(c2.eye, c2.center)), d0,
                      rtol=1e-4)
    near = cam.dollied(0.5)
    assert np.isclose(np.linalg.norm(np.subtract(near.eye, near.center)),
                      0.5 * d0, rtol=1e-5)
    pan = cam.panned(0.1, 0.0)
    assert not np.allclose(pan.eye, cam.eye)
    assert np.allclose(np.subtract(pan.eye, cam.eye),
                       np.subtract(pan.center, cam.center), atol=1e-5)
    fly = cam.flown(0.5, 0.1, 0.2)
    assert np.allclose(fly.basis()[2], cam.basis()[2], atol=1e-6)
    walk = cam.walked(0.5, 0.2)
    assert np.isclose(walk.eye[1], cam.eye[1], atol=1e-6)


# ---------------------------- Manipulator --------------------------------


def _state_machine(m):
    mm = m.Manipulator(width=100, height=100)
    mm.set_mouse_position(50, 50)
    acts = [mm.mouse_move(55, 50, lmb=True),
            mm.mouse_move(55, 55, lmb=True, shift=True),
            mm.mouse_move(50, 55, lmb=True, ctrl=True),
            mm.mouse_move(45, 55, lmb=True, alt=True),
            mm.mouse_move(45, 50, mmb=True),
            mm.mouse_move(45, 45, rmb=True),
            mm.mouse_move(40, 45)]
    mm.mode = mm.FLY
    acts += [mm.mouse_move(40, 40, lmb=True),
             mm.mouse_move(35, 40, lmb=True, alt=True)]
    return acts, man_state(mm)


def _orbit(m):
    mm = m.Manipulator(m.Camera(), width=200, height=200)
    mm.set_mouse_position(100, 100)
    mm.mouse_move(120, 90, lmb=True)
    return man_state(mm)


def _trackball(m):
    mm = m.Manipulator(m.Camera(), width=200, height=200)
    mm.mode = mm.TRACKBALL
    mm.set_mouse_position(100, 100)
    mm.mouse_move(120, 110, lmb=True)
    mm.mouse_move(120, 110, lmb=True)          # degenerate: a no-op
    mm.mouse_move(190, 20, lmb=True)           # onto the hyperbolic sheet
    mm.mouse_move(170, 40, lmb=True, alt=True)  # trackball orbit, inverted
    return man_state(mm)


def _project_tb(m):
    mm = m.Manipulator()
    edge = mm.tbsize * 0.70710678118654752440
    return np.array([mm._project_tb(np.array(p)) for p in
                     ([0.0, 0.0], [edge - 1e-9, 0.0], [edge + 1e-9, 0.0],
                      [10.0, 0.0], [0.3, -0.4])])


def _dolly_never_crosses(m):
    mm = m.Manipulator(m.Camera(eye=(0, 0, 1), center=(0, 0, 0)),
                       width=100, height=100)
    mm.set_mouse_position(0, 0)
    for _ in range(50):
        mm.mouse_move(mm.mouse[0] + 30, mm.mouse[1], lmb=True, shift=True)
    return man_state(mm)


def _walk_level(m):
    mm = m.Manipulator(m.Camera(eye=(0, 1, 5), center=(0, 0, 0)),
                       width=100, height=100)
    mm.mode = mm.WALK
    mm.set_mouse_position(0, 50)
    mm.mouse_move(0, 40, rmb=True)
    return man_state(mm)


def _fly_and_wheel(m):
    mm = m.Manipulator(m.Camera(), width=640, height=360)
    mm.mode = mm.FLY
    mm.set_mouse_position(320, 180)
    mm.mouse_move(300, 170, lmb=True)          # look around
    mm.mouse_move(280, 190, mmb=True)          # pan, inverted in Fly
    mm.mouse_move(280, 150, rmb=True)          # dolly moves both points
    mm.wheel(3)
    mm.wheel(-2)
    mm.set_window_size(800, 600)
    mm.set_lookat((1, 2, 3), (0, 0, 0), (0, 0, 1))
    mm.mode = mm.WALK
    mm.mouse_move(300, 100, rmb=True)          # z-up walk zeroes z
    return np.concatenate([man_state(mm), mm.matrix().ravel(),
                           cam_state(mm.camera).ravel()])


MANIPULATOR_CASES = {
    "state_machine": _state_machine,
    "orbit": _orbit,
    "trackball": _trackball,
    "project_tb": _project_tb,
    "dolly_never_crosses": _dolly_never_crosses,
    "walk_level": _walk_level,
    "fly_and_wheel": _fly_and_wheel,
}


@pytest.mark.parametrize("case", sorted(MANIPULATOR_CASES))
def test_manipulator_matches(case):
    t, j = both(MANIPULATOR_CASES[case])
    if case == "state_machine":
        assert t[0] == j[0]
        t, j = t[1], j[1]
    np.testing.assert_array_equal(t, j)


def test_manipulator_invariants():
    """tests/test_camera.py:80-178 on the port."""
    acts, _ = _state_machine(tcam)
    m = tcam.Manipulator
    assert acts == [m.ORBIT, m.DOLLY, m.PAN, m.LOOKAROUND, m.PAN, m.DOLLY,
                    m.NONE, m.LOOKAROUND, m.ORBIT]
    mm = tcam.Manipulator(tcam.Camera(), width=200, height=200)
    mm.set_mouse_position(100, 100)
    r0 = np.linalg.norm(mm.pos - mm.int)
    mm.mouse_move(120, 90, lmb=True)
    assert np.isclose(np.linalg.norm(mm.pos - mm.int), r0, rtol=1e-6)
    assert np.allclose(mm.int, np.asarray(tcam.Camera().center))
    pt = _project_tb(tcam)
    assert np.isclose(pt[0], 0.8) and np.isclose(pt[1], pt[2], atol=1e-6)
    assert pt[3] < 0.1
    assert _dolly_never_crosses(tcam)[2] > 0.0
    assert np.isclose(_walk_level(tcam)[1], 1.0)
    tb = tcam.Manipulator(tcam.Camera(), width=200, height=200)
    tb.mode = tb.TRACKBALL
    tb.set_mouse_position(100, 100)
    up0 = tb.up.copy()
    tb.mouse_move(120, 110, lmb=True)
    assert np.isclose(np.linalg.norm(tb.pos - tb.int), r0, rtol=1e-6)
    assert not np.allclose(tb.up, up0)
    view = mm.matrix()
    np.testing.assert_array_equal(view, tcam.look_at(mm.pos, mm.int, mm.up))
    assert mm.camera.eye == tuple(np.float32(mm.pos))
