"""OGC XML documents of the WMS front end.

Counterpart of `gsky_tpu/server/templates.py`, WMS half: the
ServiceException report and the WMS 1.3.0 GetCapabilities document,
built with the reference's structure and text, so both packages answer
one config with the same document.
"""

from __future__ import annotations

from xml.sax.saxutils import escape

from .config import Config, Layer


def service_exception(message: str, code: str = "") -> str:
    attr = f' exceptionCode="{escape(code)}"' if code else ""
    return (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        '<ServiceExceptionReport version="1.3.0" '
        'xmlns="http://www.opengis.net/ogc">\n'
        f"  <ServiceException{attr}>{escape(message)}</ServiceException>\n"
        "</ServiceExceptionReport>\n"
    )


def _layer_xml(lay: Layer, ns_path: str, host: str) -> str:
    bbox = lay.default_geo_bbox or [-180, -90, 180, 90]
    dates = ",".join(lay.dates)
    default_date = lay.effective_end_date or ""
    styles = lay.styles or [lay]
    style_xml = []
    for s in styles:
        legend = (f'      <LegendURL width="{s.legend_width}" '
                  f'height="{s.legend_height}">\n'
                  f'        <Format>image/png</Format>\n'
                  f'        <OnlineResource xmlns:xlink='
                  f'"http://www.w3.org/1999/xlink" xlink:type="simple" '
                  f'xlink:href="{escape(host)}{ns_path}?service=WMS&amp;'
                  f'request=GetLegendGraphic&amp;layer={escape(lay.name)}'
                  f'&amp;style={escape(s.name)}"/>\n'
                  f"      </LegendURL>\n") if (s.legend_path or s.palette) \
            else ""
        style_xml.append(
            f"    <Style>\n"
            f"      <Name>{escape(s.name)}</Name>\n"
            f"      <Title>{escape(s.title or s.name)}</Title>\n"
            f"{legend}"
            f"    </Style>\n")
    dims = ""
    if dates:
        dims = (f'    <Dimension name="time" units="ISO8601" '
                f'default="{escape(default_date)}">{escape(dates)}'
                f"</Dimension>\n")
    for ax in lay.axes_info:
        vals = ",".join(ax.values)
        dims += (f'    <Dimension name="{escape(ax.name)}" units="" '
                 f'default="{escape(ax.default)}">{escape(vals)}'
                 f"</Dimension>\n")
    return (
        f'  <Layer queryable="1">\n'
        f"    <Name>{escape(lay.name)}</Name>\n"
        f"    <Title>{escape(lay.title or lay.name)}</Title>\n"
        f"    <Abstract>{escape(lay.abstract)}</Abstract>\n"
        f"    <CRS>EPSG:3857</CRS>\n"
        f"    <CRS>EPSG:4326</CRS>\n"
        f"    <EX_GeographicBoundingBox>\n"
        f"      <westBoundLongitude>{bbox[0]}</westBoundLongitude>\n"
        f"      <eastBoundLongitude>{bbox[2]}</eastBoundLongitude>\n"
        f"      <southBoundLatitude>{bbox[1]}</southBoundLatitude>\n"
        f"      <northBoundLatitude>{bbox[3]}</northBoundLatitude>\n"
        f"    </EX_GeographicBoundingBox>\n"
        f'    <BoundingBox CRS="CRS:84" minx="{bbox[0]}" miny="{bbox[1]}" '
        f'maxx="{bbox[2]}" maxy="{bbox[3]}"/>\n'
        f"{dims}"
        f"{''.join(style_xml)}"
        f"  </Layer>\n"
    )


def wms_capabilities(cfg: Config, ns_path: str, host: str) -> str:
    layers = "".join(_layer_xml(l, ns_path, host) for l in cfg.layers
                     if not l.service_disabled("wms")
                     and l.visibility != "hidden")
    url = f"{host}{ns_path}"
    return (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        '<WMS_Capabilities version="1.3.0" '
        'xmlns="http://www.opengis.net/wms" '
        'xmlns:xlink="http://www.w3.org/1999/xlink">\n'
        "<Service>\n"
        "  <Name>WMS</Name>\n"
        "  <Title>GSKY-TPU Web Map Service</Title>\n"
        "  <Abstract>TPU-native distributed geospatial data server"
        "</Abstract>\n"
        f'  <OnlineResource xlink:type="simple" xlink:href="{escape(url)}"/>\n'
        f"  <MaxWidth>{max((l.wms_max_width for l in cfg.layers), default=512)}</MaxWidth>\n"
        f"  <MaxHeight>{max((l.wms_max_height for l in cfg.layers), default=512)}</MaxHeight>\n"
        "</Service>\n"
        "<Capability>\n"
        "  <Request>\n"
        "    <GetCapabilities>\n"
        "      <Format>text/xml</Format>\n"
        f"{_dcp(url)}"
        "    </GetCapabilities>\n"
        "    <GetMap>\n"
        "      <Format>image/png</Format>\n"
        f"{_dcp(url)}"
        "    </GetMap>\n"
        "    <GetFeatureInfo>\n"
        "      <Format>application/json</Format>\n"
        f"{_dcp(url)}"
        "    </GetFeatureInfo>\n"
        "  </Request>\n"
        "  <Exception><Format>XML</Format></Exception>\n"
        '  <Layer>\n'
        "    <Title>GSKY-TPU Layers</Title>\n"
        "    <CRS>EPSG:3857</CRS>\n"
        "    <CRS>EPSG:4326</CRS>\n"
        f"{layers}"
        "  </Layer>\n"
        "</Capability>\n"
        "</WMS_Capabilities>\n"
    )


def _dcp(url: str) -> str:
    return ('      <DCPType><HTTP><Get><OnlineResource xlink:type="simple" '
            f'xlink:href="{escape(url)}"/></Get></HTTP></DCPType>\n')
