"""mrays_per_s (Mrays/s): every ray of every frame completed in the
window, over the window's seconds: W*H primary rays a frame, one shadow
ray per hit pixel and light, one AO probe per hit pixel and sample."""


def read(w):
    return w.rays / w.window_s / 1e6
