"""window_img_s.*: the untraced window's trained images a second, as
``train_img_s`` takes them (all images of the window's steps over its host
seconds), for a cell whose rate is too unsteady to hold end to end: the
host-bound hg8 step follows the shared host's speed."""


def read(ctx):
    return ctx.window.get("train_img_s")
