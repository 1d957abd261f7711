"""The orbit loop: the scan loaded in set-up, then Engine.render frames in
a closed loop along the app's orbit (loops.Pose, with the traffic's zoom
cycle). Set-up runs one whole cycle, so that the window meets no view it
has not drawn. The answers: every frame of the window, none of which may
drop samples (`frames_truncated`), and frames drawn from the seed, drawn
again by the reference."""
import random
import time

from lodbench import reference as ref
from lodbench.devtrace import span
from lodbench.loops import Loop, Pose, pixels_off, state_tensors, tree_numbers


class OrbitLoop(Loop):
    def setup(self):
        eng, ctx = self.eng, self.ctx
        ctx.open(eng)
        eng.load_all()
        self.sync()
        self.pose = Pose(ctx.extent, ctx.traffic, ctx.seed)
        self.rng = random.Random(ctx.seed ^ 0x5EED)
        self.keep = ctx.traffic["check_frames"]
        self.kept = []
        self.truncated = 0
        self.k = -self.pose.cycle
        while self.k < 0:
            self.frame()

    def frame(self):
        p = self.pose.apply(self.eng, self.k)
        t0 = time.perf_counter()
        with span("Engine.render"):
            img, stats = self.eng.render(self.ctx.width, self.ctx.height)
        dt = time.perf_counter() - t0
        self.k += 1
        return p, img, stats, dt

    def window(self, seconds: float) -> dict:
        eng = self.eng
        frames = []
        cap0 = eng.graphs.captures
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            p, img, stats, dt = self.frame()
            frames.append(dt)
            self.truncated += bool(stats.render_truncated)
            # a reservoir sample of the frames, drawn from the seed
            if len(self.kept) < self.keep:
                self.kept.append((p, img))
            else:
                j = self.rng.randrange(len(frames))
                if j < self.keep:
                    self.kept[j] = (p, img)
        window = time.perf_counter() - t0
        self.answers += len(frames)
        return dict(frame_s=frames, window_s=window,
                    captures=eng.graphs.captures - cap0)

    def stretch(self, seconds: float) -> dict:
        drawn, frames = 0, 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            _, _, stats, _ = self.frame()
            drawn += stats.num_visible_points + stats.num_visible_voxels
            frames += 1
        return dict(frames=frames, drawn=drawn,
                    pixels=frames * self.ctx.width * self.ctx.height)

    def check(self, scan) -> dict:
        self.eng.stream.stop()
        tree = ref.Tree(state_tensors(self.eng.state))
        out = tree_numbers(tree, scan, self.ctx)
        # the control stands for the reference, which drops no sample
        out["frames_truncated"] = 0 if self.ctx.control else self.truncated
        out["frame_pixels_off_pct"] = pixels_off(tree, scan, self.kept,
                                                 self.ctx)
        return out


LOOP = OrbitLoop
