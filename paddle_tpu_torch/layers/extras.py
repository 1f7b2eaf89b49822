"""The detection layers of ``paddle_tpu/layers/extras.py`` (ref
``python/paddle/fluid/layers/nn.py`` ``psroi_pool`` and
``layers/detection.py`` ``detection_map``). The file's other layers are
not ported yet."""

from ..core.layer_helper import LayerHelper

__all__ = ["psroi_pool", "detection_map"]


def psroi_pool(input, rois, output_channels, spatial_scale, pooled_height,
               pooled_width, name=None):
    helper = LayerHelper("psroi_pool", name=name)
    out = helper.create_variable_for_type_inference(dtype=str(input.dtype))
    helper.append_op("psroi_pool", {"X": input, "ROIs": rois}, {"Out": out},
                     {"output_channels": output_channels,
                      "spatial_scale": spatial_scale,
                      "pooled_height": pooled_height,
                      "pooled_width": pooled_width})
    return out


def detection_map(detect_res, gt_label, gt_box, class_num,
                  background_label=0, overlap_threshold=0.5,
                  ap_version="integral", name=None):
    helper = LayerHelper("detection_map", name=name)
    out = helper.create_variable_for_type_inference(dtype="float32",
                                                    shape=())
    helper.append_op("detection_map",
                     {"DetectRes": detect_res, "GtLabel": gt_label,
                      "GtBox": gt_box},
                     {"MAP": out},
                     {"class_num": class_num, "ap_type": ap_version,
                      "overlap_threshold": overlap_threshold,
                      "background_label": background_label})
    return out
