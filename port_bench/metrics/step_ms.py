"""Wall milliseconds of the window over the denoising steps completed in it
(each one or more UNet calls, as the stage's UNET_CALLS say); each
request's text encoding, VAE passes and copy to the host fall inside the
window where they happen."""


def read(ctx):
    return ctx.window_s / ctx.forwards * 1e3 if ctx.forwards else None
