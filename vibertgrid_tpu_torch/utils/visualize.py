"""Visualization diagnostics.

Port of ViBERTgrid-PyTorch's ``utils/ViBERTgrid_visualize.py``: grid heatmap
panels (:145-169), the 4-panel inference visualization (:172-206), and
class-colored box drawing saved to ``inference_result.jpg`` (:209-268).
Inputs are numpy arrays (or CPU tensors) in the NHWC layout. matplotlib/PIL
are imported lazily (headless-safe via Agg).
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import numpy as np

STANDARD_COLORS = [
    "AliceBlue", "Chartreuse", "Aqua", "Aquamarine", "Azure", "Beige",
    "Bisque", "BlanchedAlmond", "BlueViolet", "BurlyWood", "CadetBlue",
    "AntiqueWhite", "Chocolate", "Coral", "CornflowerBlue", "Cornsilk",
    "Crimson", "Cyan", "DarkCyan", "DarkGoldenRod", "DarkGrey", "DarkKhaki",
    "DarkOrange", "DarkOrchid", "DarkSalmon", "DarkSeaGreen", "DarkTurquoise",
]


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def vibertgrid_visualize(grids: Any, save_path: str = "./bertgrid_vis.png"):
    """Mean-over-channels heatmaps of a batch of BERTgrids [B, H, W, D]."""
    plt = _plt()
    grids = np.asarray(grids, np.float32)
    heat = grids.mean(axis=-1) * 255.0
    num_pic = heat.shape[0]
    width = max(int(math.sqrt(num_pic)), 1)
    height = max(int(num_pic / width), 1)
    plt.figure()
    for idx in range(num_pic):
        plt.subplot(width, height, idx + 1)
        plt.imshow(heat[idx])
    plt.savefig(save_path)
    plt.close()
    return save_path


def inference_visualize(
    image: Any,
    class_label: Any,
    pred_ss: Any,
    pred_mask: Any,
    save_path: str = "./inference_vis.png",
):
    """4-panel figure: image / predicted class map / pos-neg mask / GT.

    image [H, W, 3]; class_label [H, W]; pred_ss [H, W, C] logits;
    pred_mask [H, W, 3] logits.
    """
    plt = _plt()
    panels = [
        (np.asarray(image), "orig image"),
        (np.asarray(pred_ss).argmax(-1) * 255, "pred segmentation"),
        (np.asarray(pred_mask).argmax(-1) * 255, "pred pos neg"),
        (np.asarray(class_label) * 255, "ground truth"),
    ]
    plt.figure()
    for i, (panel, title) in enumerate(panels):
        plt.subplot(2, 2, i + 1)
        plt.imshow(panel)
        plt.title(title)
    plt.savefig(save_path)
    plt.close()
    return save_path


def draw_box(
    image: Any,
    boxes_dict_list: Sequence[dict],
    class_list: Sequence[str],
    line_thickness: int = 4,
    save_path: str = "./inference_result.jpg",
):
    """Draw class-colored boxes with labels; boxes_dict_list[class-1] maps
    text → [x0, y0, x1, y1] (reference draw_box :209-268)."""
    from PIL import Image, ImageDraw, ImageFont

    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    pil = Image.fromarray(arr)
    draw = ImageDraw.Draw(pil)
    try:
        font = ImageFont.truetype("arial.ttf", 24)
    except OSError:
        font = ImageFont.load_default()

    for idx, class_boxes in enumerate(boxes_dict_list):
        color = STANDARD_COLORS[idx % len(STANDARD_COLORS)]
        label = class_list[idx + 1] if idx + 1 < len(class_list) else str(idx)
        for _text, coor in class_boxes.items():
            left, top, right, bottom = coor
            draw.line(
                [(left, top), (left, bottom), (right, bottom), (right, top),
                 (left, top)],
                width=line_thickness,
                fill=color,
            )
            draw.text((left + 2, max(top - 14, 0)), label, fill="black", font=font)
    pil.save(save_path)
    return save_path


def dump_parameter_names(named_parameters, path: str = "model_structure.txt") -> str:
    """Write every parameter's name and shape to a text file, one a line, from
    ``model.named_parameters()``: the see_modules utility
    (``utils/see_modules.py:64-66``)."""
    with open(path, "w") as f:
        for name, param in named_parameters:
            f.write(f"{name} {tuple(param.shape)}\n")
    return path
