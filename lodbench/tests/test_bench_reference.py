"""The reference against hand-worked cases and against the port's own
tree, with faults put into it."""
import numpy as np
import pytest
import torch

from lodbench import reference as ref

CPU = torch.device("cpu")


def test_morton_decode_inverts_the_ports_encoding():
    from simlod_tpu_torch.ops import morton
    g = torch.Generator().manual_seed(1)
    q = torch.randint(0, 1 << 28, (1000, 3), generator=g, dtype=torch.int32)
    words = morton.encode(q[:, 0], q[:, 1], q[:, 2])
    assert torch.equal(ref.morton_decode(words), q.to(torch.int64))


def one_point_state(rgba=0x000000FF):
    """A root leaf holding one point at the cube's centre."""
    from simlod_tpu_torch.ops import morton
    c = torch.tensor([1 << 27], dtype=torch.int32)
    w0, w1, w2 = morton.encode(c, c, c)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)
    z = torch.zeros(0, dtype=torch.int32)
    return dict(num_nodes=i32(1), child_base=i32([-1]), parent=i32([-1]),
                level=i32([0]), nx=i32([0]), ny=i32([0]), nz=i32([0]),
                num_segments=i32(1), seg_node=i32([0]), seg_off=i32([0]),
                seg_cnt=i32([1]), pt_w0=w0, pt_w1=w1, pt_w2=w2,
                pt_rgba=i32([rgba]), vox_used=i32(0), vox_compacted=i32(0),
                vox_k0=z, vox_k1=z, vox_k2l=z, vox_rgba=z)


def test_one_point_lands_on_the_centre_pixel():
    """A camera orbiting the cube's centre sees the point on the centre
    pixel (W/2, H/2 truncated; the point lies half a grid cell past the
    centre, so its y lands a hair under 90): its colour there (HQS of one
    sample), eye-dome darkens its 4 neighbours (infinite depth beside a
    finite one) and leaves the rest of the background as it was, alpha
    255."""
    tree = ref.Tree(one_point_state(0x000000FF))
    cube = torch.tensor(100.0)
    t = ref.view_projection(-0.6, -0.8, 50.0, [50.0, 50.0, 50.0], 60.0,
                            320, 180)
    img = ref.render(tree, cube, t, 320, 180).numpy().view(np.uint32)
    assert img[89, 160] == 0xFF0000FF
    for y, x in ((88, 160), (90, 160), (89, 159), (89, 161)):
        assert img[y, x] == 0xFF000000
    assert img[10, 10] == 0xFF332211
    assert (img != 0xFF332211).sum() == 5
    # without shading the winner's colour, without EDL the plain frame
    plain = ref.render(tree, cube, t, 320, 180, hqs=False, edl_strength=None)
    assert plain.numpy().view(np.uint32)[89, 160] == 0x000000FF
    assert plain.numpy().view(np.uint32)[90, 160] == 0x00332211


def test_eye_dome_shades_by_the_depth_step():
    depth = torch.full((3, 3), 2.0)
    depth[1, 1] = 4.0          # log2 4 - log2 2 = 1 against each neighbour
    color = torch.full((9,), 0x00C8C8C8, dtype=torch.int64)
    out = ref.eye_dome(color, depth.reshape(-1), 3, 3, 0.4)
    shade = np.exp(np.float32(-(4 / 50) * 300 * 0.4))
    assert int(out[4]) & 0xFF == int(np.float32(200) * shade)
    assert int(out[0]) == 0xFFC8C8C8


def test_pixels_off_counts_a_step_of_two():
    a = torch.tensor([0x10203040, 0, 0, 0], dtype=torch.int32)
    one = torch.tensor([0x010101, 0, 0, 0], dtype=torch.int32)
    assert ref.pixels_off_pct(a, a + one) == 0.0
    assert ref.pixels_off_pct(a, a + 2 * one) == 25.0
    # alpha is not compared
    assert ref.pixels_off_pct(a, a | (0x7F << 24)) == 0.0


@pytest.fixture(scope="module")
def built():
    """A small tree built by the port on the CPU, and its scan."""
    import small
    from simlod_tpu_torch.config import Settings
    from simlod_tpu_torch.engine import Engine
    from lodbench import data, found
    from lodbench.loops import state_tensors
    import tempfile
    d = tempfile.mkdtemp()
    xyz, rgba = data.terrain(120_000, 5, CPU)
    path = d + "/scan.simlod"
    found.module("formats", "simlod").write(path, xyz, rgba)
    eng = Engine(small.small_cfg(), Settings(), device="cpu")
    eng.open([path])
    eng.load_all()
    eng.render(160, 90)          # compacts
    return state_tensors(eng.state), ref.read_scan(path, "simlod", CPU)


def checks(state, scan):
    return ref.tree_checks(ref.Tree(state), scan, leaf_cap=2000)


def test_the_ports_tree_passes(built):
    state, scan = built
    out = checks(state, scan)
    assert all(v == 0 for v in out.values()), out


@pytest.mark.parametrize("fault,number", [
    ("colour", "points_mismatched"), ("move", "points_mismatched"),
    ("drop", "points_mismatched"), ("voxel_colour", "voxel_colors_foreign"),
    ("voxel_twice", "voxels_duplicated"), ("leaf_cap", "leaves_overfull"),
    ("child", "nodes_malformed")])
def test_a_fault_shows(built, fault, number):
    state, scan = built
    s = {k: v.clone() for k, v in state.items()}
    row = int(s["seg_off"][(s["seg_cnt"] > 0).nonzero()[0, 0]])
    if fault == "colour":
        s["pt_rgba"][row] ^= 0x10
    elif fault == "move":
        s["pt_w2"][row] ^= 0x7
    elif fault == "drop":
        i = (s["seg_cnt"] > 0).nonzero()[0, 0]
        s["seg_cnt"][i] -= 1
    elif fault == "voxel_colour":
        s["vox_rgba"][0] ^= 0x00808000
    elif fault == "voxel_twice":
        for k in ("vox_k0", "vox_k1", "vox_k2l", "vox_rgba"):
            s[k][1] = s[k][0]
    elif fault == "leaf_cap":
        out = ref.tree_checks(ref.Tree(s), scan, leaf_cap=10)
        assert out[number] > 0
        return
    elif fault == "child":
        inner = (s["child_base"][:int(s["num_nodes"])] >= 0).nonzero()[0, 0]
        c = int(s["child_base"][inner])
        s["nx"][c] += 1
    out = checks(s, scan)
    assert out[number] > 0, out
