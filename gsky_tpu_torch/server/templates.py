"""OGC XML documents of the OWS front end.

Counterpart of `gsky_tpu/server/templates.py`: the ServiceException
report, the WMS 1.3.0 GetCapabilities and DescribeLayer documents, the
WCS 1.0.0 GetCapabilities and DescribeCoverage documents, and the WPS
1.0.0 GetCapabilities, DescribeProcess and Execute response documents,
built
with the reference's structure and text, so both packages answer one
config with the same document (the Execute response's creation time
aside).
"""

from __future__ import annotations

import datetime as dt
from typing import List
from xml.sax.saxutils import escape

from .config import Config, Layer, ProcessConfig


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


def wcs_capabilities(cfg: Config, ns_path: str, host: str) -> str:
    url = f"{host}{ns_path}"
    coverages = "".join(
        f"    <CoverageOfferingBrief>\n"
        f"      <name>{escape(l.name)}</name>\n"
        f"      <label>{escape(l.title or l.name)}</label>\n"
        f"      <lonLatEnvelope srsName=\"urn:ogc:def:crs:OGC:1.3:CRS84\">\n"
        f"        <gml:pos>{(l.default_geo_bbox or [-180, -90, 180, 90])[0]}"
        f" {(l.default_geo_bbox or [-180, -90, 180, 90])[1]}</gml:pos>\n"
        f"        <gml:pos>{(l.default_geo_bbox or [-180, -90, 180, 90])[2]}"
        f" {(l.default_geo_bbox or [-180, -90, 180, 90])[3]}</gml:pos>\n"
        f"      </lonLatEnvelope>\n"
        f"    </CoverageOfferingBrief>\n"
        for l in cfg.layers if not l.service_disabled("wcs"))
    return (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        '<WCS_Capabilities version="1.0.0" '
        'xmlns="http://www.opengis.net/wcs" '
        'xmlns:gml="http://www.opengis.net/gml" '
        'xmlns:xlink="http://www.w3.org/1999/xlink">\n'
        "  <Service>\n"
        "    <name>GSKY-TPU WCS</name>\n"
        "    <label>TPU-native Web Coverage Service</label>\n"
        "  </Service>\n"
        "  <Capability>\n"
        "    <Request>\n"
        "      <GetCapabilities>\n"
        f'        <DCPType><HTTP><Get><OnlineResource xlink:href='
        f'"{escape(url)}"/></Get></HTTP></DCPType>\n'
        "      </GetCapabilities>\n"
        "      <DescribeCoverage>\n"
        f'        <DCPType><HTTP><Get><OnlineResource xlink:href='
        f'"{escape(url)}"/></Get></HTTP></DCPType>\n'
        "      </DescribeCoverage>\n"
        "      <GetCoverage>\n"
        f'        <DCPType><HTTP><Get><OnlineResource xlink:href='
        f'"{escape(url)}"/></Get></HTTP></DCPType>\n'
        "      </GetCoverage>\n"
        "    </Request>\n"
        "  </Capability>\n"
        "  <ContentMetadata>\n"
        f"{coverages}"
        "  </ContentMetadata>\n"
        "</WCS_Capabilities>\n"
    )


def wcs_describe_coverage(layers: List[Layer], host: str) -> str:
    body = ""
    for l in layers:
        bbox = l.default_geo_bbox or [-180, -90, 180, 90]
        dates = "".join(f"        <gml:timePosition>{escape(d)}"
                        f"</gml:timePosition>\n" for d in l.dates[:2000])
        body += (
            f"  <CoverageOffering>\n"
            f"    <name>{escape(l.name)}</name>\n"
            f"    <label>{escape(l.title or l.name)}</label>\n"
            f"    <domainSet>\n"
            f"      <spatialDomain>\n"
            f'        <gml:Envelope srsName="EPSG:4326">\n'
            f"          <gml:pos>{bbox[0]} {bbox[1]}</gml:pos>\n"
            f"          <gml:pos>{bbox[2]} {bbox[3]}</gml:pos>\n"
            f"        </gml:Envelope>\n"
            f"      </spatialDomain>\n"
            f"      <temporalDomain>\n{dates}      </temporalDomain>\n"
            f"    </domainSet>\n"
            f"    <supportedCRSs>\n"
            f"      <requestResponseCRSs>EPSG:4326</requestResponseCRSs>\n"
            f"      <requestResponseCRSs>EPSG:3857</requestResponseCRSs>\n"
            f"    </supportedCRSs>\n"
            f"    <supportedFormats>\n"
            f"      <formats>GeoTIFF</formats>\n"
            f"      <formats>NetCDF</formats>\n"
            f"    </supportedFormats>\n"
            f"  </CoverageOffering>\n")
    return (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        '<CoverageDescription version="1.0.0" '
        'xmlns="http://www.opengis.net/wcs" '
        'xmlns:gml="http://www.opengis.net/gml">\n'
        f"{body}"
        "</CoverageDescription>\n"
    )


def wms_describe_layer(layers: List[Layer], ns_path: str, host: str) -> str:
    body = "".join(
        f'  <LayerDescription name="{escape(l.name)}" '
        f'wfs="" owsType="WCS" owsURL="{escape(host)}{ns_path}">\n'
        f'    <Query typeName="{escape(l.name)}"/>\n'
        f"  </LayerDescription>\n" for l in layers)
    return (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        '<WMS_DescribeLayerResponse version="1.1.1">\n'
        f"{body}"
        "</WMS_DescribeLayerResponse>\n"
    )


def wps_capabilities(cfg: Config, ns_path: str, host: str) -> str:
    procs = "".join(
        f"    <wps:Process wps:processVersion=\"1.0.0\">\n"
        f"      <ows:Identifier>{escape(p.identifier)}</ows:Identifier>\n"
        f"      <ows:Title>{escape(p.title or p.identifier)}</ows:Title>\n"
        f"      <ows:Abstract>{escape(p.abstract)}</ows:Abstract>\n"
        f"    </wps:Process>\n" for p in cfg.processes)
    return (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        '<wps:Capabilities service="WPS" version="1.0.0" '
        'xmlns:wps="http://www.opengis.net/wps/1.0.0" '
        'xmlns:ows="http://www.opengis.net/ows/1.1">\n'
        "  <wps:ProcessOfferings>\n"
        f"{procs}"
        "  </wps:ProcessOfferings>\n"
        "</wps:Capabilities>\n"
    )


def wps_describe_process(p: ProcessConfig) -> str:
    lits = "".join(
        f"      <Input minOccurs=\"{d.get('min_occurs', 0)}\">\n"
        f"        <ows:Identifier>{escape(d.get('identifier', ''))}"
        f"</ows:Identifier>\n"
        f"        <ows:Title>{escape(d.get('title', ''))}</ows:Title>\n"
        f"        <LiteralData/>\n"
        f"      </Input>\n" for d in p.literal_data)
    comps = "".join(
        f"      <Input minOccurs=\"{d.get('min_occurs', 0)}\">\n"
        f"        <ows:Identifier>{escape(d.get('identifier', ''))}"
        f"</ows:Identifier>\n"
        f"        <ows:Title>{escape(d.get('title', ''))}</ows:Title>\n"
        f"        <ComplexData/>\n"
        f"      </Input>\n" for d in p.complex_data)
    return (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        '<wps:ProcessDescriptions service="WPS" version="1.0.0" '
        'xmlns:wps="http://www.opengis.net/wps/1.0.0" '
        'xmlns:ows="http://www.opengis.net/ows/1.1">\n'
        '  <ProcessDescription wps:processVersion="1.0.0">\n'
        f"    <ows:Identifier>{escape(p.identifier)}</ows:Identifier>\n"
        f"    <ows:Title>{escape(p.title or p.identifier)}</ows:Title>\n"
        f"    <ows:Abstract>{escape(p.abstract)}</ows:Abstract>\n"
        "    <DataInputs>\n"
        f"{lits}{comps}"
        "    </DataInputs>\n"
        "  </ProcessDescription>\n"
        "</wps:ProcessDescriptions>\n"
    )


def wps_execute_response(identifier: str, csv_blocks: List[str],
                         status: str = "ProcessSucceeded") -> str:
    now = dt.datetime.now(dt.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")
    outputs = "".join(
        "    <wps:Output>\n"
        "      <ows:Identifier>output</ows:Identifier>\n"
        "      <wps:Data>\n"
        f'        <wps:ComplexData mimeType="text/csv">'
        f"{escape(block)}</wps:ComplexData>\n"
        "      </wps:Data>\n"
        "    </wps:Output>\n" for block in csv_blocks)
    return (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        '<wps:ExecuteResponse service="WPS" version="1.0.0" '
        'xmlns:wps="http://www.opengis.net/wps/1.0.0" '
        'xmlns:ows="http://www.opengis.net/ows/1.1">\n'
        "  <wps:Process>\n"
        f"    <ows:Identifier>{escape(identifier)}</ows:Identifier>\n"
        "  </wps:Process>\n"
        f'  <wps:Status creationTime="{now}">\n'
        f"    <wps:{status}/>\n"
        "  </wps:Status>\n"
        "  <wps:ProcessOutputs>\n"
        f"{outputs}"
        "  </wps:ProcessOutputs>\n"
        "</wps:ExecuteResponse>\n"
    )
