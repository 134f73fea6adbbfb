"""Host seconds of the scene's build in set-up: the GLB and ``.hdr``
loaders (decode, the probe's tables), the fitted light and
``Driver.upload_scene`` (flattening, the BVH, the atlas, the upload),
to the card's synchronisation."""


def read(ctx):
    return ctx.scene_build_s
