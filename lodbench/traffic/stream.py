"""The stream loop: the simultaneous loop (Engine.open with chunk_steps,
then Engine.frame under the app's orbit until drained, then open again).
A window runs whole loads until its time has passed. The answers: every
frame of the window, none of which may drop samples (`frames_truncated`);
one fused frame of the window drawn from the seed, with a copy of the
octree it was drawn from, taken right after it; the octree of the window's
last load and the frame that follows it (render-only: the stream is
drained)."""
import random
import time

from lodbench import reference as ref
from lodbench.devtrace import span
from lodbench.loops import Loop, Pose, pixels_off, state_tensors, tree_numbers

# what the reference reads of the octree (ref.Tree)
TREE_KEYS = ("num_nodes", "child_base", "parent", "level", "nx", "ny", "nz",
             "num_segments", "seg_node", "seg_off", "seg_cnt", "pt_w0",
             "pt_w1", "pt_w2", "pt_rgba", "vox_used", "vox_compacted",
             "vox_k0", "vox_k1", "vox_k2l", "vox_rgba")


class StreamLoop(Loop):
    def setup(self):
        ctx = self.ctx
        self.pose = Pose(ctx.extent, ctx.traffic, ctx.seed)
        self.rng = random.Random(ctx.seed ^ 0x5EED)
        self.k = 0
        self.truncated = 0
        self.kept = None
        self.copy_at = None
        # a whole load warms every shape; the frames of a load that can be
        # checked are known from it
        ok = [i for i, (_, fit) in enumerate(self.load()) if fit]
        self.truncated = 0
        self.copy_at = self.rng.choice(ok) if ok else 0

    def reopen(self):
        with span("Engine.open"):
            self.ctx.open(self.eng, self.ctx.traffic["chunk_steps"])

    def frame(self):
        eng = self.eng
        p = self.pose.apply(eng, self.k)
        fused = eng.t_fused.count
        t0 = time.perf_counter()
        with span("Engine.frame"):
            img, stats = eng.frame(self.ctx.width, self.ctx.height)
        dt = time.perf_counter() - t0
        self.k += 1
        self.truncated += bool(stats.render_truncated)
        # a fused frame after which the octree did not change (no capacity
        # poll, so no compaction; not the load's last, so no split
        # convergence): its octree is the one it drew
        fit = eng.t_fused.count > fused and eng._steps_since_poll > 0 \
            and not eng.last_batch_finished
        return p, img, dt, fit

    def load(self) -> list:
        """One whole load through the loop -> (wall seconds, whether it
        can be checked) of its frames. The first frame that can be checked
        at or after the frame drawn from the seed is kept, with a copy of
        its octree."""
        self.reopen()
        frames = []
        while not self.eng.last_batch_finished:
            p, img, dt, fit = self.frame()
            frames.append((dt, fit))
            if fit and self.kept is None and self.copy_at is not None \
                    and len(frames) > self.copy_at:
                state = state_tensors(self.eng.state)
                self.kept = (p, img, {k: state[k].clone() for k in TREE_KEYS})
        return frames

    def window(self, seconds: float) -> dict:
        eng = self.eng
        frames, loads, points, steps, nframes = [], 0, 0, 0, 0
        t0 = time.perf_counter()
        while True:
            frames += [dt for dt, _ in self.load()]
            points += eng.stream.total_points
            steps += eng.steps
            nframes += eng.frames
            loads += 1
            if time.perf_counter() - t0 >= seconds:
                break
        window = time.perf_counter() - t0
        self.answers += len(frames)
        return dict(frame_s=frames, window_s=window, points=points,
                    loads=loads, steps=steps, frames=nframes)

    stretch = window

    def check(self, scan) -> dict:
        eng = self.eng
        p, img, _, _ = self.frame()
        truncated = self.truncated
        tree = ref.Tree(state_tensors(eng.state))
        out = tree_numbers(tree, scan, self.ctx)
        last = pixels_off(tree, scan, [(p, img)], self.ctx)
        del tree
        # the control stands for the reference, which drops no sample
        out["frames_truncated"] = 0 if self.ctx.control else truncated
        out["frames_unchecked"] = int(self.kept is None)
        out["frame_pixels_off_pct"] = last
        out["fused_frame_pixels_off_pct"] = 0.0
        if self.kept is not None:
            p, img, state = self.kept
            self.kept = None
            out["fused_frame_pixels_off_pct"] = pixels_off(
                ref.Tree(state), scan, [(p, img)], self.ctx)
            del state
        return out


LOOP = StreamLoop
