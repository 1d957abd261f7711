"""The load loop: whole drag-and-drop loads, back to back (Engine.open,
then load_all, ending in a device sync). The window starts loads until its
time has passed and runs the last to its end; the answer checked is the
octree of the window's last load."""
import time

from lodbench import reference as ref
from lodbench.devtrace import span
from lodbench.loops import Loop, state_tensors, tree_numbers


class LoadLoop(Loop):
    def one(self) -> dict:
        eng = self.eng
        t0 = time.perf_counter()
        with span("Engine.open"):
            self.ctx.open(eng)
        with span("Engine.load_all"):
            eng.load_all()
        self.sync()
        self.answers += 1
        return dict(points=eng.stream.total_points,
                    seconds=time.perf_counter() - t0,
                    host_syncs=eng.host_syncs, t_decode=eng.stream.t_decode)

    def setup(self):
        self.one()

    def window(self, seconds: float) -> dict:
        loads = []
        t0 = time.perf_counter()
        while True:
            loads.append(self.one())
            if time.perf_counter() - t0 >= seconds:
                break
        return dict(loads=loads, window_s=time.perf_counter() - t0)

    stretch = window

    def check(self, scan) -> dict:
        self.eng.stream.stop()
        return tree_numbers(ref.Tree(state_tensors(self.eng.state)), scan,
                            self.ctx)

    def info(self, window: dict) -> dict:
        return {"load_s": [x["seconds"] for x in window["loads"]]}


LOOP = LoadLoop
