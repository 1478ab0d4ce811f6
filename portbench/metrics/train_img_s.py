"""train_img_s: real images consumed by the training steps completed in the
window, over the window (from its start to the last step's end on the
device), host clock."""


def read(run):
    return run.data.get("train_img_s")
